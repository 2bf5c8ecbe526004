"""Raw Sentinel-2 10 m / 20 m ingest of the port against proteus_tpu's
(JAX on the CPU), tolerance 0: ``ops/resample.py::resample_to_30m`` as
float32 arrays, and whole bands with fill pixels through both packages'
``io/hls.py``.
"""

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu.io import hls as jhls
from proteus_tpu.io.cog import write_cog
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.ops.resample import resample_to_30m as jax_resample
from proteus_tpu.runtime.orchestrator import \
    generate_dswx_layers as jax_generate
from proteus_tpu_torch.io import hls as thls
from proteus_tpu_torch.ops.resample import resample_to_30m
from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers

torch.set_num_threads(1)


@pytest.mark.parametrize('dtype', [np.int16, np.float32])
@pytest.mark.parametrize('res,shape', [
    (10, (30, 30)), (10, (31, 32)), (10, (3, 299)), (10, (95, 64)),
    (20, (16, 16)), (20, (17, 20)), (20, (1, 7)), (20, (33, 50)),
    (30, (5, 9))])
def test_resample_to_30m_matches_jax(res, shape, dtype):
    """Even and odd shapes (trailing rows and columns that fill no whole
    window are dropped); the float32 values themselves are equal."""
    rng = np.random.default_rng(res * 1000 + shape[0] * 10 + shape[1])
    band = rng.integers(-9999, 20000, shape).astype(dtype)
    want = np.asarray(jax_resample(band, res))
    got = resample_to_30m(torch.from_numpy(band), res).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if res == 10:
        # rint of the mean is the integer of the exact quotient
        sums = band[:shape[0] // 3 * 3, :shape[1] // 3 * 3].astype(
            np.int64).reshape(shape[0] // 3, 3, shape[1] // 3, 3).sum((1, 3))
        np.testing.assert_array_equal(np.rint(got), np.rint(sums / 9.0))


@pytest.mark.parametrize('res', [0, 15, 60])
def test_resample_to_30m_refuses_other_resolutions(res):
    band = torch.zeros((6, 6), dtype=torch.int16)
    with pytest.raises(ValueError, match='unsupported source resolution'):
        jax_resample(band.numpy(), res)
    with pytest.raises(ValueError, match='unsupported source resolution'):
        resample_to_30m(band, res)


def _raw_band(tmp_path, res, size, psy_sign=-1.0):
    """A raw Sentinel-2 blue band on a ``res`` m grid with fill pixels,
    single and in blocks, written with the reference's writer."""
    rng = np.random.default_rng(res + size)
    band = rng.integers(-300, 12000, (size, size)).astype(np.int16)
    band[rng.random((size, size)) < 0.01] = -9999
    band[5:9, 11:14] = -9999
    path = str(tmp_path / f'S2.T15SXS.{res}m.B02.tif')
    gt = (synthetic.X0, float(res), 0.0, synthetic.Y0, 0.0,
          psy_sign * float(res))
    write_cog(path, band, geotransform=gt, epsg=synthetic.EPSG,
              nodata=-9999, metadata=dict(synthetic.HLS_METADATA),
              overview_levels=())
    return path, band


@pytest.mark.parametrize('scaled', [False, True])
@pytest.mark.parametrize('res,size', [(10, 96), (10, 100), (20, 64),
                                      (20, 65)])
def test_raw_band_ingest_matches_jax(tmp_path, res, size, scaled):
    path, band = _raw_band(tmp_path, res, size)
    results = []
    for module, extra in ((jhls, {}),
                          (thls, {'device': torch.device('cpu')})):
        image, offset, scale, md = {}, {}, {}, {}
        assert module.load_hls_band(path, image, offset, scale, md, 'blue',
                                    scaled, **extra) is True
        results.append((image, offset, scale, md))
    (ji, jo, js, jm), (ti, to, ts, tm) = results
    assert (jo, js, jm) == (to, ts, tm)
    assert sorted(ji) == sorted(ti)
    for key, want in ji.items():
        if isinstance(want, np.ndarray):
            assert ti[key].dtype == want.dtype, key
            np.testing.assert_array_equal(ti[key], want, err_msg=key)
        else:
            assert ti[key] == want, key
    assert ti['geotransform'][1] == 30.0 and ti['geotransform'][5] == -30.0
    n30 = size // 3 if res == 10 else (3 * size) // 2
    assert ti['blue'].shape == (n30, n30) == (ti['length'], ti['width'])
    assert ti['invalid_ind_array'].any() and not ti['invalid_ind_array'].all()
    if res == 10:
        fill = (band == -9999)[:n30 * 3, :n30 * 3].reshape(
            n30, 3, n30, 3).any(axis=(1, 3))
        np.testing.assert_array_equal(ti['invalid_ind_array'], fill)


def test_raw_band_ingest_south_up_grid(tmp_path):
    path, _ = _raw_band(tmp_path, 10, 33, psy_sign=1.0)
    ji, ti = {}, {}
    assert jhls.load_hls_band(path, ji, {}, {}, {}, 'blue', False)
    assert thls.load_hls_band(path, ti, {}, {}, {}, 'blue', False,
                              device=torch.device('cpu'))
    assert ti['geotransform'] == ji['geotransform']
    assert abs(ti['geotransform'][5]) == 30.0
    np.testing.assert_array_equal(ti['blue'], ji['blue'])


@pytest.mark.parametrize('res', [10, 20])
def test_raw_band_ingest_needs_a_device(tmp_path, res):
    """A 10 m or 20 m band without ``device=`` raises instead of
    resampling quietly on the CPU; a 30 m band needs none."""
    path, _ = _raw_band(tmp_path, res, 30)
    with pytest.raises(ValueError, match='pass device='):
        thls.load_hls_band(path, {}, {}, {}, {}, 'blue', False)
    files, _ = synthetic.make_hls_v2_dataset(str(tmp_path / 'in'), size=12)
    assert thls.load_hls_product_v2(files, {}, {}, {}, {}, False)


def test_fmask_on_a_10m_grid_is_not_resampled(tmp_path):
    path, band = _raw_band(tmp_path, 10, 30)
    ti = {}
    assert thls.load_hls_band(path, ti, {}, {}, {}, 'fmask', False)
    assert ti['fmask'].shape == band.shape


def test_product_run_on_10m_and_20m_bands(tmp_path):
    """A whole product run whose blue band comes on a 10 m grid and whose
    swir1 band on a 20 m grid runs to its end (the hook raised
    NotImplementedError before) and writes proteus_tpu's WTR; with the
    10 m band a 3x repeat of the 30 m one, the 30 m band is recovered
    exactly."""
    size = 30
    files, bands = synthetic.make_hls_v2_dataset(str(tmp_path / 'in'),
                                                 size=size)
    rng = np.random.default_rng(4)
    raw = {'B02': (10, np.repeat(np.repeat(bands['B02'], 3, 0), 3, 1)),
           'B11': (20, rng.integers(1, 9000, (20, 20)).astype(np.int16))}
    for name, (res, array) in raw.items():
        target = [f for f in files if f.endswith(f'{name}.tif')][0]
        gt = (synthetic.X0, float(res), 0.0, synthetic.Y0, 0.0, -float(res))
        write_cog(target, array, geotransform=gt, epsg=synthetic.EPSG,
                  nodata=-9999, metadata=dict(synthetic.HLS_METADATA),
                  overview_levels=())
    image = {}
    assert thls.load_hls_product_v2(files, image, {}, {}, {}, False,
                                    device=torch.device('cpu'))
    np.testing.assert_array_equal(image['blue'],
                                  np.clip(bands['B02'], 1, None))
    assert image['swir1'].shape == (size, size)
    outs = {}
    for name, fn, extra in (('jax', jax_generate, {}),
                            ('torch', generate_dswx_layers,
                             {'device': torch.device('cpu')})):
        outs[name] = str(tmp_path / f'{name}_wtr.tif')
        assert fn(files, output_interpreted_band=outs[name],
                  output_diagnostic_layer=str(tmp_path / f'{name}_diag.tif'),
                  check_ancillary_inputs_coverage=False,
                  apply_ocean_masking=False, **extra) is True
    for suffix in ('wtr', 'diag'):
        with TiffReader(str(tmp_path / f'jax_{suffix}.tif')) as r:
            want = r.read()
        with TiffReader(str(tmp_path / f'torch_{suffix}.tif')) as r:
            np.testing.assert_array_equal(r.read(), want)
