"""The otsu shadow of the port against proteus_tpu's (JAX on the CPU) and
against the host float64 oracle, tolerance 0.

- ``compute_hillshade_exact`` and ``compute_otsu_shadow_layer_exact`` on
  the four terrains of ``tools/hillshade_tpu_parity.py:29-40`` at 256^2,
  three sun geometries and both signs of the row spacing. The DEMs hold no
  float32 subnormals (JAX's CPU backend flushes them);
- the (6,) float32 constants of ``_hillshade_consts_dd`` as arrays;
- ``_otsu_threshold_f64`` on degenerate histograms;
- a whole single-tile run with ``shadow_masking_algorithm='otsu'`` file by
  file against ``proteus_tpu``'s;
- the campaign: the reader's SHAD with otsu against the single-tile chain
  (the port's counterpart of ``tests/test_campaign.py:345``), and a
  campaign's SHAD files against the single-tile run's of both packages.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.models.dswx import shadow as jshadow
from proteus_tpu.runtime.orchestrator import \
    generate_dswx_layers as jax_generate
from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.geo.warp import warp_to_grid_device
from proteus_tpu_torch.models.dswx import shadow as tshadow
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.parallel import campaign as tcampaign
from proteus_tpu_torch.runtime.compare import compare_dswx_hls_products
from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers
from test_torch_e2e import LAYERS, _outputs

torch.set_num_threads(1)

SIZE = 256
CPU = torch.device('cpu')
GEOMETRIES = [(135.0, 45.0), (277.3, 18.0), (80.0, 70.0)]
TERRAINS = ('smooth', 'plateau_6000m', 'nan_holed', 'quadratic_sweep')


@pytest.fixture(scope='module')
def terrains():
    """tools/hillshade_tpu_parity.py:29-40 at 256^2."""
    size = SIZE
    rng = np.random.default_rng(20260818)
    base = rng.normal(0, 1, (size, size)).cumsum(0).cumsum(1)
    smooth = (base / np.abs(base).max() * 800 + 200).astype(np.float32)
    plateau = (6000.0 + rng.normal(0, 2.0, (size, size))).astype(np.float32)
    holed = smooth.copy()
    holed[rng.random((size, size)) < 0.05] = np.nan
    col = np.arange(size, dtype=np.float64)
    sweep = np.tile((0.002 * col ** 2).astype(np.float32), (size, 1))
    out = {'smooth': smooth, 'plateau_6000m': plateau, 'nan_holed': holed,
           'quadratic_sweep': sweep}
    tiny = np.finfo(np.float32).tiny
    for dem in out.values():
        finite = dem[np.isfinite(dem)]
        assert not ((finite != 0) & (np.abs(finite) < tiny)).any()
    return out


@pytest.mark.parametrize('psy', [-30.0, 30.0])
@pytest.mark.parametrize('geometry', GEOMETRIES)
@pytest.mark.parametrize('name', TERRAINS)
def test_hillshade_and_otsu_match_jax_and_the_host_oracle(terrains, name,
                                                          geometry, psy):
    dem = terrains[name]
    az, elev = geometry
    oracle = jshadow._host_hillshade_gdal(dem, az, elev, 30.0, psy)
    np.testing.assert_array_equal(
        tshadow._host_hillshade_gdal(dem, az, elev, 30.0, psy), oracle)
    want = np.asarray(jshadow.compute_hillshade_exact(
        jnp.asarray(dem), az, elev, 30.0, psy))
    got, n_band = tshadow.compute_hillshade_exact(
        torch.from_numpy(dem), az, elev, 30.0, psy, return_band=True)
    assert got.dtype == torch.uint8 and 0 <= n_band < 64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert not got[0].any() and not got[:, -1].any()  # GDAL's edge ring

    want_mask = np.asarray(jshadow.compute_otsu_shadow_layer_exact(
        jnp.asarray(dem), az, elev, 30.0, psy))
    mask = tshadow.compute_otsu_shadow_layer_exact(
        torch.from_numpy(dem), az, elev, 30.0, psy)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    threshold = jshadow._otsu_threshold_f64(np.bincount(oracle.ravel(),
                                                        minlength=256))
    np.testing.assert_array_equal(mask.numpy(), oracle > threshold)


@pytest.mark.parametrize('psx,psy', [(10.0, -10.0), (30.0, -20.0)])
def test_hillshade_other_spacings(terrains, psx, psy):
    dem = terrains['smooth'][:97, :131]  # odd, non-square
    got = tshadow.compute_hillshade_exact(torch.from_numpy(dem.copy()),
                                          200.0, 33.0, psx, psy)
    np.testing.assert_array_equal(
        got.numpy(), jshadow._host_hillshade_gdal(dem, 200.0, 33.0, psx,
                                                  psy))


def test_hillshade_band_is_decided_on_the_host(terrains, monkeypatch):
    """With the error bracket blown up every interior pixel with a finite
    window goes to the host's float64 oracle, and the bytes stay right:
    the band's path is exercised whatever its natural size."""
    dem = terrains['nan_holed']
    real = tshadow._hs_byte_map
    calls = []

    def wide(f):
        calls.append(1)
        # the 2nd and 3rd maps are the bracket's two ends
        return real(f) + (len(calls) % 3 == 0)
    monkeypatch.setattr(tshadow, '_hs_byte_map', wide)
    got, n_band = tshadow.compute_hillshade_exact(
        torch.from_numpy(dem), 135.0, 45.0, 30.0, -30.0, return_band=True)
    windows_finite = np.isfinite(
        np.stack(list(tshadow._hillshade_windows_np(dem).values()))).all(0)
    windows_finite[0] = windows_finite[-1] = False
    windows_finite[:, 0] = windows_finite[:, -1] = False
    assert n_band == int(windows_finite.sum()) > 30000
    np.testing.assert_array_equal(
        got.numpy(), jshadow._host_hillshade_gdal(dem, 135.0, 45.0, 30.0,
                                                  -30.0))


@pytest.mark.parametrize('az,elev', GEOMETRIES + [(0.0, 90.0)])
def test_hillshade_consts_dd(az, elev):
    want = np.asarray(jshadow._hillshade_consts_dd(az, elev))
    got = tshadow._hillshade_consts_dd(az, elev)
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_array_equal(got, want)


def _hist(**counts):
    h = np.zeros(256, np.int64)
    for value, n in counts.items():
        h[int(value[1:])] = n
    return h


@pytest.mark.parametrize('name,hist', [
    ('empty', _hist()),
    ('one-value', _hist(v7=100)),
    ('one-value-zero', _hist(v0=5)),
    ('two-values', _hist(v0=10, v200=30)),
    ('two-adjacent', _hist(v100=1, v101=1)),
    ('ring-and-flat', _hist(v0=1020, v181=65536)),
    ('full-range', np.arange(256, dtype=np.int64) + 1),
])
def test_otsu_threshold_degenerate_histograms(name, hist):
    want = jshadow._otsu_threshold_f64(hist)
    got = tshadow._otsu_threshold_f64(hist)
    if want is None:
        assert got is None
    else:
        assert isinstance(got, float)
        np.testing.assert_array_equal(np.float64(got), np.float64(want))


def test_otsu_mask_of_a_flat_dem():
    """A flat DEM: one interior byte and the zero ring."""
    dem = np.full((40, 50), 123.0, np.float32)
    want = np.asarray(jshadow.compute_otsu_shadow_layer_exact(
        jnp.asarray(dem), 135.0, 45.0))
    got = tshadow.compute_otsu_shadow_layer_exact(torch.from_numpy(dem),
                                                  135.0, 45.0)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- a whole single-tile run with the otsu shadow ---------------------------

E2E_SIZE = 160


@pytest.fixture(scope='module')
def otsu_products(tmp_path_factory):
    root = tmp_path_factory.mktemp('otsu')
    files, _ = synthetic.make_hls_v2_dataset(str(root / 'input'),
                                             size=E2E_SIZE)
    inputs = dict(
        input_list=files,
        dem_file=synthetic.make_dem(str(root), size=E2E_SIZE),
        landcover_file=synthetic.make_landcover(str(root), size=E2E_SIZE),
        worldcover_file=synthetic.make_worldcover(str(root), size=E2E_SIZE),
        worldcover_file_description='ESA WorldCover 10m 2021',
        check_ancillary_inputs_coverage=True,
        shadow_masking_algorithm='otsu')
    dirs = {}
    for name, fn, extra in (('jax', jax_generate, {}),
                            ('torch', generate_dswx_layers,
                             {'device': CPU})):
        out_dir = str(root / name)
        os.makedirs(out_dir)
        assert fn(**inputs, **_outputs(out_dir), **extra) is True
        dirs[name] = out_dir
    return root, inputs, dirs


@pytest.mark.parametrize('name', [f'B{nn:02}_{layer}.tif' for nn, layer in
                                  enumerate(LAYERS, start=1)]
                         + ['BROWSE.tif'])
def test_otsu_product_file_matches_jax(otsu_products, name):
    _, _, dirs = otsu_products
    want_path = os.path.join(dirs['jax'], name)
    got_path = os.path.join(dirs['torch'], name)
    with TiffReader(want_path) as r:
        want = r.read()
        want_md = r.metadata()
    with TiffReader(got_path) as r:
        got = r.read()
        got_md = r.metadata()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert compare_dswx_hls_products(want_path, got_path)
    assert got_md.get('SHADOW_MASKING_ALGORITHM') == \
        want_md.get('SHADOW_MASKING_ALGORITHM') == 'OTSU'


def test_otsu_shad_is_the_otsu_chain_and_not_the_default(otsu_products):
    root, inputs, dirs = otsu_products
    with TiffReader(os.path.join(dirs['torch'], 'B08_SHAD.tif')) as r:
        shad = r.read()
        gt = r.geotransform()
    assert set(np.unique(shad).tolist()) == {0, 1}
    from proteus_tpu_torch.geo.crs import CRS
    m = C.DEM_MARGIN_IN_PIXELS
    dem_m = warp_to_grid_device(
        inputs['dem_file'], gt, CRS.from_epsg(synthetic.EPSG).to_wkt(),
        E2E_SIZE, E2E_SIZE, resample_algorithm='cubic', margin_in_pixels=m,
        device=CPU)
    md = synthetic.HLS_METADATA
    az = float(md['MEAN_SUN_AZIMUTH_ANGLE'])
    elev = 90 - float(md['MEAN_SUN_ZENITH_ANGLE'])
    hs = tshadow._host_hillshade_gdal(dem_m.numpy(), az, elev, gt[1], gt[5])
    want = hs > tshadow._otsu_threshold_f64(np.bincount(hs.ravel(),
                                                        minlength=256))
    np.testing.assert_array_equal(shad, want[m:-m, m:-m].astype(np.uint8))
    default = tshadow.compute_opera_shadow_layer_exact(dem_m, az, elev, -5,
                                                       40)
    assert (default[m:-m, m:-m].numpy() != (shad != 0)).any()


# ---- the campaign ------------------------------------------------------------

def test_campaign_reader_otsu_shadow(tmp_path):
    """The reader honours shadow_masking_algorithm='otsu': its SHAD equals
    the exact otsu chain over the same warped, margined DEM and differs
    from the default algorithm's; the cache keys the two apart."""
    tcampaign.ANCILLARY_CACHE.clear()
    files, _ = synthetic.make_hls_v2_dataset(str(tmp_path / 'in'), size=96)
    dem = synthetic.make_dem(str(tmp_path), size=96)
    job = tcampaign.TileJob('c0', files, str(tmp_path / 'o'), dem_file=dem)
    tile = tcampaign._read_tile(
        job, config=DswxChainConfig(shadow_masking_algorithm='otsu'),
        device=CPU)
    m = C.DEM_MARGIN_IN_PIXELS
    dem_m = warp_to_grid_device(
        dem, tile['geotransform'], tile['projection'], 96, 96,
        resample_algorithm='cubic', margin_in_pixels=m, device=CPU)
    md = synthetic.HLS_METADATA
    az = float(md['MEAN_SUN_AZIMUTH_ANGLE'])
    zen = float(md['MEAN_SUN_ZENITH_ANGLE'])
    gt = tile['geotransform']
    want = tshadow.compute_otsu_shadow_layer_exact(
        dem_m, az, 90.0 - zen, pixel_spacing_x=gt[1], pixel_spacing_y=gt[5])
    jwant = np.asarray(jshadow.compute_otsu_shadow_layer_exact(
        jnp.asarray(dem_m.numpy()), az, 90.0 - zen, pixel_spacing_x=gt[1],
        pixel_spacing_y=gt[5]))
    got = tile['shadow_layer'].numpy()
    np.testing.assert_array_equal(got, want[m:-m, m:-m].numpy()
                                  .astype(np.uint8))
    np.testing.assert_array_equal(got, jwant[m:-m, m:-m].astype(np.uint8))
    default = tcampaign._read_tile(job, config=DswxChainConfig(), device=CPU)
    assert (default['shadow_layer'].numpy() != got).any()
    again = tcampaign._read_tile(
        job, config=DswxChainConfig(shadow_masking_algorithm='otsu'),
        device=CPU)
    np.testing.assert_array_equal(again['shadow_layer'].numpy(), got)
    tcampaign.ANCILLARY_CACHE.clear()


def test_campaign_with_otsu_matches_the_single_tile_runs(otsu_products,
                                                         tmp_path):
    """A campaign with otsu over two copies of the tile: every science
    layer equals the single-tile otsu run of the port and of proteus_tpu
    (the reference's otsu campaign is not trusted on its own; ROADMAP,
    known faults in the reference)."""
    root, inputs, dirs = otsu_products
    tcampaign.ANCILLARY_CACHE.clear()
    out = str(tmp_path / 'campaign')
    jobs = [tcampaign.TileJob(
        f'tile_{t}', inputs['input_list'], os.path.join(out, f'tile_{t}'),
        product_id=f'tile_{t}', dem_file=inputs['dem_file'],
        landcover_file=inputs['landcover_file'],
        worldcover_file=inputs['worldcover_file']) for t in range(2)]
    runner = tcampaign.CampaignRunner(
        config=DswxChainConfig(shadow_masking_algorithm='otsu'),
        mesh=[CPU] * 2, save_browse=True)
    stats = runner.run(jobs)
    assert stats['tiles_done'] == 2 and stats['tiles_failed'] == 0
    for t in range(2):
        for nn, layer in enumerate(LAYERS, start=1):
            got_path = glob.glob(os.path.join(
                out, f'tile_{t}', f'*_B{nn:02}_{layer}.tif'))
            assert len(got_path) == 1, (t, layer)
            with TiffReader(got_path[0]) as r:
                got = r.read()
            for package in ('torch', 'jax'):
                with TiffReader(os.path.join(
                        dirs[package], f'B{nn:02}_{layer}.tif')) as r:
                    np.testing.assert_array_equal(
                        got, r.read(), err_msg=f'{t} {layer} {package}')
    tcampaign.ANCILLARY_CACHE.clear()
