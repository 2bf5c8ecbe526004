"""The whole slice: proteus_tpu_torch.generate_dswx_layers against
proteus_tpu's on the same synthetic tile (DEM, CGLS and WorldCover),
product file by product file, tolerance 0; plus the guards of the port:
it never imports jax or proteus_tpu and never picks a device on its own.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu.io.cog import write_cog
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.runtime.orchestrator import \
    generate_dswx_layers as jax_generate
from proteus_tpu_torch.device import resolve_device
from proteus_tpu_torch.runtime.compare import compare_dswx_hls_products
from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers

torch.set_num_threads(1)

SIZE = 160
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = ['WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'LAND', 'SHAD',
          'CLOUD', 'DEM']
OUTPUT_ARGS = ['output_interpreted_band', 'output_binary_water',
               'output_confidence_layer', 'output_diagnostic_layer',
               'output_non_masked_dswx', 'output_shadow_masked_dswx',
               'output_landcover', 'output_shadow_layer',
               'output_cloud_layer', 'output_dem_layer']
CPU = torch.device('cpu')


def _inputs(root):
    files, _ = synthetic.make_hls_v2_dataset(str(root / 'input'), size=SIZE)
    return dict(
        input_list=files,
        dem_file=synthetic.make_dem(str(root), size=SIZE),
        landcover_file=synthetic.make_landcover(str(root), size=SIZE),
        worldcover_file=synthetic.make_worldcover(str(root), size=SIZE),
        worldcover_file_description='ESA WorldCover 10m 2021',
        check_ancillary_inputs_coverage=True)


def _outputs(out_dir):
    kw = {arg: os.path.join(out_dir, f'B{nn:02}_{layer}.tif')
          for nn, (arg, layer) in enumerate(zip(OUTPUT_ARGS, LAYERS),
                                            start=1)}
    kw['output_browse_image'] = os.path.join(out_dir, 'BROWSE.png')
    kw['scratch_dir'] = os.path.join(out_dir, 'scratch')
    return kw


@pytest.fixture(scope='module')
def products(tmp_path_factory):
    root = tmp_path_factory.mktemp('e2e')
    inputs = _inputs(root)
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
def test_product_file_matches_jax(products, name):
    _, _, dirs = products
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
    for key in ('SPATIAL_COVERAGE', 'CLOUD_COVERAGE'):
        assert got_md.get(key) == want_md.get(key), key


def test_browse_png_matches_jax(products):
    _, _, dirs = products
    with open(os.path.join(dirs['jax'], 'BROWSE.png'), 'rb') as fh:
        want = fh.read()
    with open(os.path.join(dirs['torch'], 'BROWSE.png'), 'rb') as fh:
        assert fh.read() == want


def test_layers_are_not_trivial(products):
    _, _, dirs = products
    for name, expect in (('B08_SHAD.tif', {0, 1}),
                         ('B01_WTR.tif', {0, 1, 252, 253})):
        with TiffReader(os.path.join(dirs['torch'], name)) as r:
            assert expect <= set(np.unique(r.read()).tolist()), name


@pytest.mark.parametrize('change', [
    dict(shadow_masking_algorithm='otsu'),
    dict(shadow_masking_algorithm='otsu', mask_adjacent_to_cloud_mode='cover'),
])
def test_ported_paths_no_longer_raise(products, tmp_path, change):
    """The otsu shadow runs (tests/test_torch_otsu.py holds it against
    proteus_tpu); its SHAD differs from the default algorithm's."""
    _, inputs, dirs = products
    out = str(tmp_path)
    assert generate_dswx_layers(**inputs, **_outputs(out), **change,
                                device=CPU) is True
    with TiffReader(os.path.join(out, 'B08_SHAD.tif')) as r:
        shad = r.read()
    with TiffReader(os.path.join(dirs['torch'], 'B08_SHAD.tif')) as r:
        assert (r.read() != shad).any()


def test_raw_sentinel2_10m_bands_ingest(tmp_path):
    """A 10 m blue band (3x the tile's shape) no longer raises: it is
    resampled to the 30 m grid and the run writes its product
    (tests/test_torch_resample.py holds the values against proteus_tpu)."""
    files, bands = synthetic.make_hls_v2_dataset(str(tmp_path / 'in'),
                                                 size=32)
    gt = (synthetic.X0, 10.0, 0.0, synthetic.Y0, 0.0, -10.0)
    write_cog(files[0], np.repeat(np.repeat(bands['B02'], 3, 0), 3, 1),
              geotransform=gt, epsg=synthetic.EPSG,
              nodata=-9999, metadata=dict(synthetic.HLS_METADATA),
              overview_levels=())
    out = str(tmp_path / 'wtr.tif')
    assert generate_dswx_layers(files, output_interpreted_band=out,
                                check_ancillary_inputs_coverage=False,
                                apply_ocean_masking=False, device=CPU) is True
    with TiffReader(out) as r:
        assert r.read().shape == (32, 32)


def test_generate_requires_a_device(products, tmp_path):
    _, inputs, _ = products
    with pytest.raises(ValueError, match='device'):
        generate_dswx_layers(**inputs, **_outputs(str(tmp_path)))


def test_resolve_device_never_falls_back(monkeypatch):
    assert resolve_device('cpu') == CPU
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        resolve_device('cuda')
    with pytest.raises(RuntimeError, match='cuda'):
        resolve_device('cuda:0')


_NO_JAX_SCRIPT = r'''
import importlib, os, pkgutil, sys, tempfile
import proteus_tpu_torch
names = [m.name for m in pkgutil.walk_packages(proteus_tpu_torch.__path__,
                                               'proteus_tpu_torch.')]
for name in names:
    importlib.import_module(name)
assert len(names) >= 20, names
from proteus_tpu_torch.testing import synthetic
from proteus_tpu_torch.cli.dswx_hls import main
with tempfile.TemporaryDirectory() as root:
    synthetic.make_hls_v2_dataset(os.path.join(root, 'input'), size=64)
    rc = synthetic.write_runconfig(
        os.path.join(root, 'rc.yaml'), os.path.join(root, 'input'),
        os.path.join(root, 'out'), os.path.join(root, 'scratch'),
        dem_file=synthetic.make_dem(root, size=64),
        landcover_file=synthetic.make_landcover(root, size=64),
        worldcover_file=synthetic.make_worldcover(root, size=64),
        check_coverage=True)
    assert main([rc]) is True
    assert len(os.listdir(os.path.join(root, 'out'))) == 12
    # scaled inputs, 'cover' mode and ocean masking
    rc = synthetic.write_runconfig(
        os.path.join(root, 'rc2.yaml'), os.path.join(root, 'input'),
        os.path.join(root, 'out2'), os.path.join(root, 'scratch'),
        shoreline_shapefile=synthetic.make_shoreline(root, size=64),
        apply_ocean_masking=True,
        extra_processing={'mask_adjacent_to_cloud_mode': 'cover',
                          'ocean_masking_shoreline_distance_km': 0.3})
    assert main([rc, '--offset-and-scale-inputs']) is True
    from proteus_tpu_torch.io.tiff import TiffReader
    out = os.path.join(root, 'out2', 'dswx_hls_test_v0.1_B01_WTR.tif')
    with TiffReader(out) as r:
        assert (r.read() == 254).any()
sys.stdout = sys.__stdout__
print('proteus_tpu loaded:', sorted(m for m in sys.modules
                                    if m.split('.')[0] == 'proteus_tpu'))
print('jax loaded:', 'jax' in sys.modules)
'''


def test_port_never_imports_jax():
    """Import every module of the port and run the slice through its CLI
    in a fresh interpreter (tests/conftest.py imports jax in this one):
    neither jax nor any module of proteus_tpu is loaded."""
    env = dict(os.environ, PROTEUS_TPU_TORCH_DEVICE='cpu',
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              'tests')]))
    proc = subprocess.run([sys.executable, '-c', _NO_JAX_SCRIPT], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-2:] == [
        'proteus_tpu loaded: []', 'jax loaded: False']
