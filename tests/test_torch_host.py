"""The port's copies of the JAX package's host code against the originals,
and the rule that the port imports neither ``jax`` nor ``proteus_tpu``.

The copies (GeoTIFF/COG I/O and the native codec, CRS, runconfig, HLS
ingest, the synthetic tile writers) must write the same bytes and read,
transform and parse to the same values as the originals.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

import synthetic
from proteus_tpu import native as jnative
from proteus_tpu.config.runconfig import parse_runconfig_file as jax_parse
from proteus_tpu.geo.crs import CRS as JaxCRS
from proteus_tpu.geo import mgrs as jmgrs
from proteus_tpu.geo.crs import transform_points as jax_transform
from proteus_tpu.io import hls as jhls
from proteus_tpu.io.cog import write_cog as jax_write_cog
from proteus_tpu.io.tiff import TiffReader as JaxTiffReader
from proteus_tpu.runtime import compare as jcompare
from proteus_tpu_torch import native as tnative
from proteus_tpu_torch.config.runconfig import parse_runconfig_file
from proteus_tpu_torch.geo import mgrs as tmgrs
from proteus_tpu_torch.geo.crs import CRS, transform_points
from proteus_tpu_torch.io import hls as thls
from proteus_tpu_torch.io.cog import write_cog
from proteus_tpu_torch.io.tiff import TiffReader
from proteus_tpu_torch.native import build as native_build
from proteus_tpu_torch.cli import dswx_compare as tcompare_cli
from proteus_tpu_torch.runtime import compare as tcompare
from proteus_tpu_torch.testing import synthetic as tsynthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(os.path.join(REPO, 'proteus_tpu_torch')):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_proteus_tpu():
    """An AST scan of every .py under proteus_tpu_torch/ and of
    chip_smoke.py: no import of jax or of proteus_tpu(.*)."""
    files = _port_sources()
    assert len(files) > 60
    scanned = {os.path.relpath(f, REPO) for f in files}
    for tool in ('kernel_profile', 'bench', 'bench_e2e', 'bench_cold_grid',
                 'host_budget', 'bench_batch', 'campaign_soak',
                 'soak_back_to_back', 'datasets'):
        assert f'proteus_tpu_torch/tools/{tool}.py' in scanned
    assert {'proteus_tpu_torch/runtime/compare.py',
            'proteus_tpu_torch/cli/dswx_compare.py',
            'proteus_tpu_torch/cli/validate_cog.py',
            'proteus_tpu_torch/geo/mgrs.py',
            'proteus_tpu_torch/ops/null_kernel.py'} <= scanned
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f)
           if m.split('.')[0] in ('jax', 'jaxlib', 'proteus_tpu')]
    assert bad == []
    assert not os.path.exists(os.path.join(REPO, 'proteus_tpu_torch',
                                           'host.py'))


# ---- COG writing and reading ------------------------------------------

def _arrays():
    rng = np.random.default_rng(5)
    f32 = rng.normal(100, 30, (300, 260)).astype(np.float32)
    f32[:7, :9] = np.nan
    return {
        'u8': (rng.integers(0, 256, (300, 260)).astype(np.uint8),
               dict(nodata=255, color_map={0: (0, 0, 0), 1: (0, 0, 255)})),
        'i16': (rng.integers(-9999, 15000, (300, 260)).astype(np.int16),
                dict(nodata=-9999)),
        'f32': (f32, dict(nodata=float('nan'))),
        'u16_rgb': (rng.integers(0, 65535, (300, 260, 3)).astype(np.uint16),
                    dict(band_descriptions={0: 'r', 1: 'g', 2: 'b'})),
    }


@pytest.fixture(params=['native', 'pure-Python'])
def codec(request, monkeypatch):
    if request.param == 'pure-Python':
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, '_LIB', None)
            monkeypatch.setattr(mod, '_TRIED', True)
    else:
        assert tnative.available() and jnative.available()
    return request.param


@pytest.mark.parametrize('name', sorted(_arrays()))
def test_write_cog_same_bytes(tmp_path, codec, name):
    array, kw = _arrays()[name]
    gt = synthetic.geotransform()
    md = {'PRODUCT': 'test', 'N': '1'}
    paths = []
    for tag, fn in (('jax', jax_write_cog), ('torch', write_cog)):
        path = str(tmp_path / f'{tag}.tif')
        fn(path, array, geotransform=gt, epsg=synthetic.EPSG, metadata=md,
           **kw)
        paths.append(path)
    with open(paths[0], 'rb') as a, open(paths[1], 'rb') as b:
        assert a.read() == b.read()
    assert tnative.codec().startswith('native') == (codec == 'native')


@pytest.mark.parametrize('name', sorted(_arrays()))
def test_tiff_reader_same_arrays(tmp_path, name):
    array, kw = _arrays()[name]
    path = str(tmp_path / 'x.tif')
    jax_write_cog(path, array, geotransform=synthetic.geotransform(),
                  epsg=synthetic.EPSG, **kw)
    with JaxTiffReader(path) as rj, TiffReader(path) as rt:
        np.testing.assert_array_equal(rt.read(), rj.read())
        np.testing.assert_array_equal(rt.read(window=(10, 20, 50, 70)),
                                      rj.read(window=(10, 20, 50, 70)))
        assert rt.geotransform() == rj.geotransform()
        assert rt.epsg() == rj.epsg() == synthetic.EPSG
        assert rt.metadata() == rj.metadata()
        assert rt.band_descriptions() == rj.band_descriptions()
        assert rt.color_map() == rj.color_map()
        assert rt.nodata() == rj.nodata() or (
            np.isnan(rt.nodata()) and np.isnan(rj.nodata()))


def test_native_codec_builds_from_the_port():
    """The port's loader builds its own library from its copy of
    tiffturbo.cpp into build/torch_native/ and names what it linked."""
    assert tnative.available()
    path = native_build.lib_path()
    assert os.path.dirname(path) == os.path.join(REPO, 'build',
                                                 'torch_native')
    assert os.path.isfile(path)
    assert native_build.linked() in ('libdeflate', 'zlib')
    assert tnative.codec() == f'native ({native_build.linked()})'
    assert native_build.SRC == os.path.join(REPO, 'proteus_tpu_torch',
                                            'native', 'tiffturbo.cpp')


@pytest.mark.parametrize('step', ['build', 'load'])
def test_native_codec_names_why_it_fell_back(monkeypatch, caplog, step):
    """A failed build or load of the native library still falls back to
    the pure-Python codec, but ``codec()`` names the step and the first
    line of its error, and the loader logs it once, as a warning."""
    monkeypatch.delenv('PROTEUS_TPU_NO_NATIVE', raising=False)
    monkeypatch.setattr(tnative, '_LIB', None)
    monkeypatch.setattr(tnative, '_TRIED', False)
    monkeypatch.setattr(tnative, '_FAILED', None)
    if step == 'build':
        def broken_build(verbose=True):
            raise RuntimeError('g++: fatal error: no input files\nmore')
        monkeypatch.setattr(native_build, 'lib_is_fresh', lambda: False)
        monkeypatch.setattr(native_build, 'build', broken_build)
        reason = 'build failed: RuntimeError: g++: fatal error: no input files'
    else:
        missing = os.path.join(REPO, 'build', 'torch_native', 'missing.so')
        monkeypatch.setattr(native_build, 'lib_is_fresh', lambda: True)
        monkeypatch.setattr(native_build, 'lib_path', lambda: missing)
        reason = 'load failed: OSError: '
    with caplog.at_level('WARNING', logger='proteus_tpu_torch.native'):
        assert not tnative.available()
        assert tnative.codec().startswith(f'pure-Python ({reason}')
        assert tnative.codec().endswith(')')
        assert tnative.lut8(np.zeros(4, np.uint8),
                            np.arange(256, dtype=np.uint8)) is None
    warnings = [r for r in caplog.records
                if r.name == 'proteus_tpu_torch.native']
    assert len(warnings) == 1 and warnings[0].levelname == 'WARNING'
    assert reason in warnings[0].getMessage()


# ---- CRS ----------------------------------------------------------------

# one or more codes of each projection family, with a lon/lat box inside
# its area of use
CRS_CASES = {
    32615: (-96, -90, 25, 35), 32733: (12, 18, -30, -20),
    2193: (170, 176, -45, -37), 5514: (13, 22, 48, 51),
    3978: (-110, -70, 45, 60), 3413: (-60, 20, 65, 85),
    3031: (-180, 180, -85, -65), 26931: (-140, -130, 54, 58),
    28992: (4, 7, 51, 53), 2056: (6, 10, 46, 47.5),
    5070: (-120, -75, 25, 48), 3035: (-5, 25, 40, 60),
    6933: (-170, 170, -80, 80), 3857: (-170, 170, -80, 80),
    4087: (-170, 170, -80, 80), 27700: (-5, 1, 50, 58),
    2154: (-2, 7, 43, 50),
}


@pytest.mark.parametrize('epsg', sorted(CRS_CASES))
def test_crs_transforms_agree(epsg):
    lon0, lon1, lat0, lat1 = CRS_CASES[epsg]
    rng = np.random.default_rng(epsg)
    lon = rng.uniform(lon0, lon1, 500)
    lat = rng.uniform(lat0, lat1, 500)
    fwd = transform_points(CRS.from_epsg(4326), CRS.from_epsg(epsg), lon,
                           lat)
    jfwd = jax_transform(JaxCRS.from_epsg(4326), JaxCRS.from_epsg(epsg),
                         lon, lat)
    np.testing.assert_array_equal(fwd, jfwd)
    back = transform_points(CRS.from_epsg(epsg), CRS.from_epsg(4326), *fwd)
    jback = jax_transform(JaxCRS.from_epsg(epsg), JaxCRS.from_epsg(4326),
                          *jfwd)
    np.testing.assert_array_equal(back, jback)
    assert CRS.from_epsg(epsg).to_wkt() == JaxCRS.from_epsg(epsg).to_wkt()


# ---- runconfig ----------------------------------------------------------

def _runconfigs(tmp_path):
    rc = synthetic.write_runconfig(
        str(tmp_path / 'rc.yaml'), str(tmp_path / 'in'),
        str(tmp_path / 'out'), str(tmp_path / 'scratch'),
        dem_file='dem.tif', landcover_file='lc.tif',
        worldcover_file='wc.tif', shoreline_shapefile='shore.shp',
        check_coverage=True, apply_ocean_masking=True,
        extra_processing={'mask_adjacent_to_cloud_mode': 'cover',
                          'ocean_masking_shoreline_distance_km': 0.3},
        thresholds={'wigt': 0.2, 'pswt_1_ndvi': 0.6})
    return [None, rc]


@pytest.mark.parametrize('which', ['default', 'test'])
def test_parse_runconfig_agrees(tmp_path, which):
    path = _runconfigs(tmp_path)[which == 'test']
    got = dataclasses.asdict(parse_runconfig_file(path))
    want = dataclasses.asdict(jax_parse(path))
    assert got == want
    if which == 'test':
        assert got['mask_adjacent_to_cloud_mode'] == 'cover'
        assert got['hls_thresholds']['wigt'] == 0.2


# ---- HLS ingest ----------------------------------------------------------

@pytest.mark.parametrize('scaled', [False, True])
def test_hls_v2_ingest_agrees(tmp_path, scaled):
    files, _ = synthetic.make_hls_v2_dataset(str(tmp_path / 'in'), size=80)
    results = []
    for module in (jhls, thls):
        image, offset, scale, md = {}, {}, {}, {}
        assert module.load_hls_product_v2(files, image, offset, scale, md,
                                          scaled)
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
    assert ti['blue'].dtype == (np.float32 if scaled else np.int16)


# ---- the synthetic tile writers --------------------------------------------

def _tree_bytes(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, 'rb') as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize('size,seed', [(48, 11), (90, 3)])
def test_synthetic_copy_writes_identical_files(tmp_path, size, seed):
    trees = []
    for tag, module in (('jax', synthetic), ('torch', tsynthetic)):
        root = tmp_path / tag
        _, bands = module.make_hls_v2_dataset(str(root / 'in'), size=size,
                                              seed=seed)
        module.make_dem(str(root), size=size)
        module.make_landcover(str(root), size=size)
        module.make_worldcover(str(root), size=size)
        module.make_shoreline(str(root), size=size)
        module.write_runconfig(str(root / 'rc.yaml'), 'in', 'out', 'scr',
                               dem_file='dem.tif', check_coverage=True)
        trees.append((_tree_bytes(str(root)), bands))
    (want, wbands), (got, gbands) = trees
    assert sorted(got) == sorted(want) and len(want) >= 13
    for name in want:
        assert got[name] == want[name], name
    for name in wbands:
        np.testing.assert_array_equal(gbands[name], wbands[name])
    assert tsynthetic.geotransform() == synthetic.geotransform()
    assert tsynthetic.EPSG == synthetic.EPSG
    assert tsynthetic.HLS_METADATA == synthetic.HLS_METADATA


# ---- dswx_compare ----------------------------------------------------------

def _product(path, array, gt=None, **metadata):
    md = {'PRODUCT_ID': 'p', 'PROCESSING_DATETIME': '2026-01-01T00:00:00',
          'LICENSE': 'one', **metadata}
    write_cog(path, array, geotransform=gt or tsynthetic.geotransform(),
              epsg=tsynthetic.EPSG, nodata=255, metadata=md,
              overview_levels=())
    return path


def _compare_cases(root):
    """(file 1, file 2, verdict) by name: equal and differing products."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 3, (40, 50)).astype(np.uint8)
    other = base.copy()
    other[17, 23] ^= 1
    f32 = rng.normal(0, 1, (40, 50)).astype(np.float32)
    f32[3, 4] = np.nan
    gt2 = list(tsynthetic.geotransform())
    gt2[0] += 30.0

    def p(name, *a, **k):
        return _product(os.path.join(root, name + '.tif'), *a, **k)
    same = p('same', base)
    return {
        'identical': (same, p('identical', base), True),
        'itself': (same, same, True),
        'volatile-metadata': (same, p('volatile', base,
                                      PROCESSING_DATETIME='2027'), True),
        'license-ignored': (same, p('license', base, LICENSE='two'), True),
        'one-pixel': (same, p('pixel', other), False),
        'shape': (same, p('shape', base[:, :49]), False),
        'geotransform': (same, p('gt', base, gt=tuple(gt2)), False),
        'metadata-value': (same, p('md', base, PRODUCT_ID='q'), False),
        'metadata-extra-key': (same, p('extra', base, EXTRA='1'), False),
        'bands': (same, p('bands', np.dstack([base, base])), False),
        'missing-file': (same, os.path.join(root, 'absent.tif'), False),
        'float-nan-equal': (p('f1', f32), p('f2', f32.copy()), True),
        'float-within-tolerance': (p('f3', f32), p('f4', f32
                                                   + np.float32(1e-7)), True),
        'float-beyond-tolerance': (p('f5', f32), p('f6', f32
                                                   + np.float32(1e-3)),
                                   False),
    }


_COMPARE_NAMES = ['identical', 'itself', 'volatile-metadata',
                  'license-ignored', 'one-pixel', 'shape', 'geotransform',
                  'metadata-value', 'metadata-extra-key', 'bands',
                  'missing-file', 'float-nan-equal', 'float-within-tolerance',
                  'float-beyond-tolerance']


@pytest.mark.parametrize('name', _COMPARE_NAMES)
def test_compare_copy_agrees_with_the_original(tmp_path, capsys, name):
    cases = _compare_cases(str(tmp_path))
    assert sorted(cases) == sorted(_COMPARE_NAMES)
    f1, f2, verdict = cases[name]
    want = jcompare.compare_dswx_hls_products(f1, f2)
    want_out = capsys.readouterr().out
    got = tcompare.compare_dswx_hls_products(f1, f2)
    got_out = capsys.readouterr().out
    assert got is want is verdict
    assert got_out == want_out
    assert tcompare_cli.main([f1, f2]) is verdict


def test_compare_cli_as_a_module(tmp_path):
    """``python -m proteus_tpu_torch.cli.dswx_compare f1 f2`` with neither
    jax nor proteus_tpu loaded."""
    import subprocess
    import sys
    cases = _compare_cases(str(tmp_path))
    f1, f2, _ = cases['one-pixel']
    script = ('import sys; from proteus_tpu_torch.cli.dswx_compare import '
              'main; ok = main(sys.argv[1:]); '
              'bad = [m for m in sys.modules if m.split(".")[0] in '
              '("jax", "proteus_tpu")]; assert not bad, bad; '
              'print("VERDICT", ok)')
    for files, verdict in (((f1, f1), True), ((f1, f2), False)):
        proc = subprocess.run([sys.executable, '-c', script, *files],
                              cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert f'VERDICT {verdict}' in proc.stdout
        assert '[FAIL]' in proc.stdout or verdict


# ---- the library API --------------------------------------------------------

API_NAMES = ('generate_dswx_layers', 'compare_dswx_hls_products',
             'save_as_cog')


def test_library_api_is_lazy():
    """``import proteus_tpu_torch`` offers the reference's four names and
    loads neither torch, the codec, the orchestrator, jax nor
    proteus_tpu: each function imports its module when it is called."""
    import subprocess
    import sys
    import proteus_tpu
    names = sorted(n for n in vars(proteus_tpu) if not n.startswith('_')
                   and callable(getattr(proteus_tpu, n)))
    assert names == sorted(API_NAMES)
    script = (
        'import sys, proteus_tpu_torch as p\n'
        'assert all(callable(getattr(p, n)) for n in %r)\n'
        'assert p.__version__ == p.version.VERSION\n'
        'loaded = sorted(m for m in sys.modules if m.split(".")[0] in '
        '("jax", "torch", "numpy", "proteus_tpu") or '
        'm.startswith("proteus_tpu_torch."))\n'
        'print("LOADED", loaded)\n' % (API_NAMES,))
    proc = subprocess.run([sys.executable, '-c', script], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED ['proteus_tpu_torch.version']" in proc.stdout, proc.stdout


def test_library_api_version_matches_the_reference():
    import proteus_tpu
    import proteus_tpu_torch
    assert proteus_tpu_torch.__version__ == proteus_tpu.__version__


@pytest.mark.parametrize('name', API_NAMES)
def test_library_api_forwards(monkeypatch, name):
    """Each name forwards its arguments to the function of the same name
    in its module (``device=`` included) and returns its result."""
    import importlib
    import proteus_tpu_torch
    module = importlib.import_module({
        'generate_dswx_layers': 'proteus_tpu_torch.runtime.orchestrator',
        'compare_dswx_hls_products': 'proteus_tpu_torch.runtime.compare',
        'save_as_cog': 'proteus_tpu_torch.io.cog'}[name])
    seen = []
    monkeypatch.setattr(module, name,
                        lambda *a, **k: seen.append((a, k)) or 'result')
    assert getattr(proteus_tpu_torch, name)('x', 2, device='cpu') == 'result'
    assert seen == [(('x', 2), {'device': 'cpu'})]


def test_library_api_runs_a_product(tmp_path):
    """``proteus_tpu_torch.generate_dswx_layers(..., device=)`` writes a
    WTR layer that ``compare_dswx_hls_products`` accepts against the
    reference API's, and ``save_as_cog`` writes the reference's bytes."""
    import proteus_tpu
    import proteus_tpu_torch
    import torch
    files, _ = synthetic.make_hls_v2_dataset(str(tmp_path / 'in'), size=48)
    outs = {}
    for tag, api, extra in (('jax', proteus_tpu, {}),
                            ('torch', proteus_tpu_torch,
                             {'device': torch.device('cpu')})):
        outs[tag] = str(tmp_path / f'{tag}_wtr.tif')
        assert api.generate_dswx_layers(
            files, output_interpreted_band=outs[tag],
            check_ancillary_inputs_coverage=False,
            apply_ocean_masking=False, **extra) is True
    assert proteus_tpu_torch.compare_dswx_hls_products(outs['jax'],
                                                       outs['torch'])
    with TiffReader(outs['torch']) as rt, JaxTiffReader(outs['jax']) as rj:
        np.testing.assert_array_equal(rt.read(), rj.read())
    array = np.arange(48 * 48, dtype=np.uint8).reshape(48, 48)
    cogs = {}
    for tag, api in (('jax', proteus_tpu), ('torch', proteus_tpu_torch)):
        path = str(tmp_path / f'{tag}_cog.tif')
        write_cog(path, array, geotransform=synthetic.geotransform(),
                  epsg=synthetic.EPSG, overview_levels=())
        api.save_as_cog(path, scratch_dir=str(tmp_path))
        with open(path, 'rb') as fh:
            cogs[tag] = fh.read()
    assert cogs['torch'] == cogs['jax']


# ---- geo/mgrs.py ------------------------------------------------------------

MGRS_FUNCTIONS = ('mgrs_to_utm',
                  'get_hls_geographic_boundaries_from_mgrs_tile',
                  'mgrs_tile_geotransform')


def _mgrs_names(zone, n=6):
    """``n`` valid 100 km square names of ``zone``, from a seed: a latitude
    band, the zone's column letter set, a row letter, with and without the
    leading 'T'."""
    rng = np.random.default_rng(zone)
    cols = jmgrs._COL_LETTER_SETS[(zone - 1) % 3]
    return [f'{"T" * (k % 2)}{zone}{rng.choice(list(jmgrs._LAT_BANDS))}'
            f'{rng.choice(list(cols))}{rng.choice(list(jmgrs._ROW_LETTERS))}'
            for k in range(n)]


@pytest.mark.parametrize('zone', range(1, 61))
def test_mgrs_copy_agrees_with_the_original(zone):
    """The three functions of every zone's seeded names: the same values
    as the JAX package's."""
    names = _mgrs_names(zone) + (['T15RYP', '15ryp '] if zone == 15 else [])
    for name in names:
        for fn in MGRS_FUNCTIONS:
            assert getattr(tmgrs, fn)(name) == getattr(jmgrs, fn)(name), \
                (fn, name)


def test_mgrs_louisiana_tile():
    """tests/test_geo.py::TestMGRS's tile through the port's copy."""
    assert tmgrs.mgrs_to_utm('T15RYP') == (15, True, 700000.0, 3300000.0)
    gt, epsg, length, width = tmgrs.mgrs_tile_geotransform('T15RYP')
    assert (length, width, epsg) == (3660, 3660, 32615)
    assert gt[0] == 700000.0 - 4900.0
    assert gt[3] == 3300000.0 - 4900.0 + 109800.0


@pytest.mark.parametrize('bad', ['XX', '99ZAA', '15IYP', 'T15RYPZ', '0RYP',
                                 '61RYP', '15RAP', '16RYW'])
def test_mgrs_invalid_names_raise_in_both(bad):
    for module in (jmgrs, tmgrs):
        for fn in MGRS_FUNCTIONS:
            with pytest.raises(ValueError):
                getattr(module, fn)(bad)


# ---- cli/validate_cog.py ----------------------------------------------------

def _validate_cases(root):
    """A product COG, a file that is no TIFF and a striped GeoTIFF (no
    COG), by name."""
    from PIL import Image
    from proteus_tpu_torch.runtime import product_writer as pw
    layer = np.random.default_rng(4).integers(0, 3, (600, 520)).astype(
        np.uint8)
    cog = os.path.join(root, 'product_WTR.tif')
    pw.save_dswx_product(layer, 'WTR', cog, {'PRODUCT_ID': 'p'},
                         tsynthetic.geotransform(), tsynthetic.EPSG)
    not_tiff = os.path.join(root, 'not_a_tiff.tif')
    with open(not_tiff, 'wb') as fh:
        fh.write(b'not a tiff at all')
    striped = os.path.join(root, 'striped.tif')
    Image.fromarray(layer).save(striped)
    return {'product-cog': (cog, 0), 'not-a-tiff': (not_tiff, 1),
            'striped-geotiff': (striped, 1)}


@pytest.mark.parametrize('name', ['product-cog', 'not-a-tiff',
                                  'striped-geotiff'])
@pytest.mark.parametrize('full_check', ['yes', 'no'])
def test_validate_cog_cli_agrees_with_the_original(tmp_path, capsys, name,
                                                   full_check):
    """The same exit code and the same lines on stdout as the JAX CLI."""
    from proteus_tpu.cli.validate_cog import main as jmain
    from proteus_tpu_torch.cli.validate_cog import main as tmain
    path, rc = _validate_cases(str(tmp_path))[name]
    argv = [path, '--full-check', full_check]
    assert jmain(argv) == rc
    want = capsys.readouterr().out
    assert tmain(argv) == rc
    assert capsys.readouterr().out == want
    assert ('is a valid cloud optimized GeoTIFF' in want) == (rc == 0)


def test_validate_cog_cli_as_a_module(tmp_path):
    """``python -m proteus_tpu_torch.cli.validate_cog`` on all three
    files: exit 1 (two are no COG), one line a file plus the errors, and
    neither jax nor proteus_tpu loaded."""
    import subprocess
    import sys
    cases = _validate_cases(str(tmp_path))
    files = [cases[n][0] for n in ('product-cog', 'not-a-tiff',
                                   'striped-geotiff')]
    script = ('import runpy, sys\n'
              'sys.argv = ["validate_cog"] + sys.argv[1:]\n'
              'try:\n'
              '    runpy.run_module("proteus_tpu_torch.cli.validate_cog", '
              'run_name="__main__")\n'
              'except SystemExit as exc:\n'
              '    rc = exc.code\n'
              'bad = [m for m in sys.modules if m.split(".")[0] in '
              '("jax", "proteus_tpu")]\n'
              'print("RC", rc, "LOADED", bad)\n')
    proc = subprocess.run([sys.executable, '-c', script, *files], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == 'RC 1 LOADED []'
    assert lines[0] == f'{files[0]} is a valid cloud optimized GeoTIFF'
    assert [ln for ln in lines if ln.startswith(tmp_path.as_posix())] == [
        lines[0], f'{files[1]} is NOT a valid cloud optimized GeoTIFF:',
        f'{files[2]} is NOT a valid cloud optimized GeoTIFF:']


# ---- the console scripts ----------------------------------------------------

def _console_scripts():
    """setup.py's console scripts as {name: 'module:function'}."""
    with open(os.path.join(REPO, 'setup.py')) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if isinstance(key, ast.Constant) \
                        and key.value == 'console_scripts':
                    return dict(e.value.split('=') for e in value.elts)
    raise AssertionError('setup.py names no console_scripts')


@pytest.mark.parametrize('name', ['dswx_hls_torch', 'dswx_compare_torch',
                                  'dswx_campaign_torch'])
def test_port_console_script_resolves(name):
    """Each of the port's scripts names a callable ``main`` of the port's
    CLI of the same name; the reference's three names stay the
    reference's."""
    import importlib
    scripts = _console_scripts()
    module, function = scripts[name].split(':')
    assert module == f'proteus_tpu_torch.cli.{name[:-len("_torch")]}'
    assert function == 'main'
    assert callable(getattr(importlib.import_module(module), function))
    reference = name[:-len('_torch')]
    assert scripts[reference] == f'proteus_tpu.cli.{reference}:main'
    commands = ('dswx_hls', 'dswx_compare', 'dswx_campaign')
    assert sorted(scripts) == sorted(
        commands + tuple(f'{n}_torch' for n in commands))
