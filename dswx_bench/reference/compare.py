"""The comparison that decides ``correct``.

Each product the sample draws is read back with the benchmark's own
readers and held to the plain reference layer by layer: every number is
the count of pixels in which a layer differs from the reference (the DEM
by its float32 bits, so NaN against NaN agrees), the most over the
sampled products. The product is the reference science bit for bit, so
every limit is 0. A missing file counts all its pixels.
"""

import os

import numpy as np

from dswx_bench.geotiff import read_geotiff, read_png
from dswx_bench.reference.products import LAYERS

CHECKS = LAYERS + ('BROWSE', 'BROWSE_PNG', 'failed_tiles')
LIMITS = dict.fromkeys(CHECKS, 0)


def read_product(directory, prefix):
    """{layer: array} of one product's files; a missing file is absent."""
    got = {}
    for nn, layer in enumerate(LAYERS, start=1):
        path = os.path.join(directory, f'{prefix}B{nn:02}_{layer}.tif')
        if os.path.isfile(path):
            got[layer] = read_geotiff(path)
    path = os.path.join(directory, f'{prefix}BROWSE.tif')
    if os.path.isfile(path):
        got['BROWSE'] = read_geotiff(path)
    path = os.path.join(directory, f'{prefix}BROWSE.png')
    if os.path.isfile(path):
        got['BROWSE_PNG'] = read_png(path)
    return got


def differing(got, want):
    """Pixels in which ``got`` differs from ``want`` (all of ``want``'s
    where the shapes differ or ``got`` is None)."""
    if got is None or got.shape != want.shape:
        return int(want.size)
    if want.dtype.kind == 'f':
        got = np.ascontiguousarray(got, dtype=want.dtype).view(
            f'u{want.dtype.itemsize}')
        want = np.ascontiguousarray(want).view(f'u{want.dtype.itemsize}')
    return int(np.count_nonzero(got != want))


def compare(got, want):
    """{check: pixels differing} of one product."""
    return {layer: differing(got.get(layer), want[layer])
            for layer in LAYERS + ('BROWSE', 'BROWSE_PNG')}


def worst(readings):
    """The most of each check over several products' readings."""
    out = dict.fromkeys(CHECKS, 0)
    for r in readings:
        for k, v in r.items():
            out[k] = max(out[k], v)
    return out
