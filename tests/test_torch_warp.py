"""Parity of the PyTorch device warp with proteus_tpu's device warp (JAX on
the CPU) and with the host float64 warp, tolerance 0 (NaN positions
equal).

Cubic float32 DEMs (with and without NaN nodata holes, so both the fast
and the validity-weighted accumulation run) and nearest uint8 landcover
grids (with nodata holes, and on the 3x WorldCover grid) are warped onto a
small UTM tile by all three implementations.
"""

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu.geo.crs import CRS
from proteus_tpu.geo.warp import warp_to_grid
from proteus_tpu.geo.warp import warp_to_grid_device as jax_warp
from proteus_tpu.io.cog import write_cog
from proteus_tpu_torch.geo.warp import warp_to_grid_device

torch.set_num_threads(1)

SIZE = 96
CPU = torch.device('cpu')


def _write_4326(path, arr, nodata, size=SIZE):
    lat_min, lat_max, lon_min, lon_max = synthetic._tile_latlon_bounds(size)
    h, w = arr.shape
    gt = (lon_min, (lon_max - lon_min) / w, 0.0, lat_max, 0.0,
          -(lat_max - lat_min) / h)
    write_cog(path, arr, geotransform=gt, epsg=4326, nodata=nodata,
              overview_levels=())
    return path


@pytest.fixture(scope='module')
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp('warp')
    rng = np.random.default_rng(17)
    dem_holes = rng.normal(300, 80, (160, 180)).astype(np.float32)
    yy, xx = np.mgrid[0:160, 0:180]
    dem_holes[(yy - 70) ** 2 + (xx - 90) ** 2 < 9 ** 2] = np.nan
    dem_holes[rng.random(dem_holes.shape) < 0.01] = np.nan
    lc_holes = rng.choice(np.array([20, 30, 50, 80, 111, 255], np.uint8),
                          (120, 130))
    return {
        'dem': synthetic.make_dem(str(root), size=SIZE),
        'dem_holes': _write_4326(str(root / 'dem_holes.tif'), dem_holes,
                                 float('nan')),
        'landcover': synthetic.make_landcover(str(root), size=SIZE),
        'lc_holes': _write_4326(str(root / 'lc_holes.tif'), lc_holes, 255),
        'worldcover': synthetic.make_worldcover(str(root), size=SIZE),
    }


CASES = [
    ('dem', 'cubic', 1, 50),
    ('dem_holes', 'cubic', 1, 50),
    ('dem_holes', 'bilinear', 1, 50),
    ('landcover', 'nearest', 1, 0),
    ('lc_holes', 'nearest', 1, 0),
    ('worldcover', 'nearest', 3, 0),
]


@pytest.mark.parametrize('source,algorithm,scale,margin', CASES,
                         ids=[f'{c[0]}-{c[1]}-x{c[2]}' for c in CASES])
def test_device_warp_matches_jax_and_host(sources, source, algorithm, scale,
                                          margin):
    x0, dx, _, y0, _, dy = synthetic.geotransform()
    gt = (x0, dx / scale, 0.0, y0, 0.0, dy / scale)
    proj = CRS.from_epsg(synthetic.EPSG).to_wkt()
    args = (sources[source], gt, proj, SIZE * scale, SIZE * scale)
    kw = dict(resample_algorithm=algorithm, margin_in_pixels=margin)
    got = warp_to_grid_device(*args, **kw, device=CPU)
    want_jax = np.asarray(jax_warp(*args, **kw))
    want_host = warp_to_grid(*args, **kw)
    got = got.numpy()
    assert got.dtype == want_host.dtype == want_jax.dtype
    assert got.shape == want_host.shape
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_host)
    if source == 'dem_holes':
        assert np.isnan(got).any() and np.isfinite(got).any()


def test_device_warp_requires_a_device(sources):
    with pytest.raises(ValueError, match='device'):
        warp_to_grid_device(sources['dem'], synthetic.geotransform(),
                            CRS.from_epsg(synthetic.EPSG).to_wkt(), SIZE,
                            SIZE, resample_algorithm='cubic')
