"""DSWx-HLS product comparator (golden-file checker).

Equivalent of the reference comparator used by bin/dswx_compare.py and the
workflow test (dswx_hls.py:705-871): per-band np.allclose with atol 1e-6
and equal NaNs, geotransform equality, and metadata comparison with the
LICENSE field and volatile keys excluded. The first differing pixel is
located with vectorized NumPy instead of the reference's Python pixel loop.
"""

import os

import numpy as np

from proteus_tpu_torch.core.constants import \
    COMPARE_DSWX_HLS_PRODUCTS_ERROR_TOLERANCE
from proteus_tpu_torch.io.tiff import TiffReader

METADATA_KEYS_NOT_REQUIRED_TO_MATCH = [
    'PROCESSING_DATETIME', 'DEM_SOURCE', 'LANDCOVER_SOURCE',
    'WORLDCOVER_SOURCE', 'SOFTWARE_VERSION', 'SENSOR']


def _prefix(flag_same, flag_all_ok):
    flag_all_ok[0] = flag_all_ok[0] and flag_same
    return '[OK]   ' if flag_same else '[FAIL] '


def _print_first_diff(image_1, image_2, prefix):
    a = np.asarray(image_1, dtype=np.float64)
    b = np.asarray(image_2, dtype=np.float64)
    diff = np.abs(a - b)
    both_nan = np.isnan(a) & np.isnan(b)
    bad = ~both_nan & ~(diff <= COMPARE_DSWX_HLS_PRODUCTS_ERROR_TOLERANCE)
    idx = np.argwhere(bad)
    if idx.size == 0:
        return
    i, j = idx[0]
    print(prefix + f'     * input 1 has value "{image_1[i, j]}" in'
          f' position (x: {j}, y: {i}) whereas input 2 has value'
          f' "{image_2[i, j]}" in the same position.')


def compare_dswx_hls_products(file_1, file_2):
    """Compare two DSWx-HLS products; returns True if they match."""
    for f in (file_1, file_2):
        if not os.path.isfile(f):
            print(f'ERROR file not found: {f}')
            return False

    print('Comparing files:')
    print(f'    file 1: {file_1}')
    print(f'    file 2: {file_2}')

    flag_all_ok = [True]
    prefix = ' ' * 7

    with TiffReader(file_1) as r1, TiffReader(file_2) as r2:
        nbands_1, nbands_2 = r1.count, r2.count
        same_nbands = nbands_1 == nbands_2
        print(f'{_prefix(same_nbands, flag_all_ok)}Comparing number of'
              ' bands')
        if not same_nbands:
            print(prefix + f'Input 1 has {nbands_1} bands and input 2 has'
                  f' {nbands_2} bands')
            return False

        print('Comparing DSWx bands...')
        descriptions = r1.band_descriptions()
        arr1 = r1.read()
        arr2 = r2.read()
        if arr1.ndim == 2:
            arr1 = arr1[:, :, None]
            arr2 = arr2[:, :, None]
        for b in range(nbands_1):
            image_1 = arr1[:, :, b]
            image_2 = arr2[:, :, b]
            equal = (image_1.shape == image_2.shape) and bool(np.allclose(
                image_1, image_2,
                atol=COMPARE_DSWX_HLS_PRODUCTS_ERROR_TOLERANCE,
                equal_nan=True))
            desc = descriptions.get(b, '')
            print(f'{_prefix(equal, flag_all_ok)}     Band {b + 1} -'
                  f' {desc}"')
            if not equal and image_1.shape == image_2.shape:
                _print_first_diff(image_1, image_2, prefix)

        gt_same = np.array_equal(r1.geotransform(), r2.geotransform())
        print(f'{_prefix(gt_same, flag_all_ok)}Comparing geotransform')
        if not gt_same:
            print(prefix + f'* input 1 geotransform with content'
                  f' "{r1.geotransform()}" differs from input 2'
                  f' geotransform with content "{r2.geotransform()}".')

        md_error, md_same = compare_dswx_hls_metadata(r1.metadata(),
                                                      r2.metadata())
        print(f'{_prefix(md_same, flag_all_ok)}Comparing metadata')
        if not md_same:
            print(prefix + md_error)

    return flag_all_ok[0]


def compare_dswx_hls_metadata(metadata_1, metadata_2):
    """Compare metadata dicts; LICENSE and volatile keys are excluded."""
    metadata_1 = dict(metadata_1)
    metadata_2 = dict(metadata_2)
    for md in (metadata_1, metadata_2):
        md.pop('LICENSE', None)

    if len(metadata_1) != len(metadata_2):
        msg = (f'* input 1 metadata has {len(metadata_1)} entries whereas'
               f' input 2 metadata has {len(metadata_2)} entries.')
        extra_1 = set(metadata_1) - set(metadata_2)
        if extra_1:
            msg += (' Input 1 metadata has extra entries with keys:'
                    f' {", ".join(sorted(extra_1))}.')
        extra_2 = set(metadata_2) - set(metadata_1)
        if extra_2:
            msg += (' Input 2 metadata has extra entries with keys:'
                    f' {", ".join(sorted(extra_2))}.')
        return msg, False

    for k, v in metadata_1.items():
        if k not in metadata_2:
            return (f'* the metadata key {k} is present in input 1 but it'
                    ' is not present in input 2'), False
        if k in METADATA_KEYS_NOT_REQUIRED_TO_MATCH:
            continue
        if metadata_2[k] != v:
            return (f'* contents of metadata key {k} from input 1 has'
                    f' value "{v}" whereas the same key in input 2'
                    f' metadata has value "{metadata_2[k]}"'), False
    return None, True
