"""The product run's layer saves on its save pool
(``runtime/orchestrator.py::_LayerSaves``):

- every file a product run writes is, byte for byte, what its save
  function writes when called alone with the same arguments and the final
  metadata: one case a file;
- the VRT's members, the standalone files and the VRT's XML keep the
  reference's order, with the DEM's save made to finish late;
- a save, an early payload or the chain that raises makes the run raise,
  and no thread of the pool is left;
- the counters: three early payloads and one pooled save a COG file, a
  product, and no hit of the COG payload cache across two products of the
  same input; the campaign's DEM payload is still reused on a revisit.
"""

import glob
import logging
import os
import threading
import time

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu_torch.io import cog
from proteus_tpu_torch.io.tiff import TiffReader
from proteus_tpu_torch.io.validate_cog import validate_cog
from proteus_tpu_torch.io.vrt import build_vrt
from proteus_tpu_torch.parallel import campaign
from proteus_tpu_torch.runtime import orchestrator as orch
from proteus_tpu_torch.runtime import product_writer as pw
from proteus_tpu_torch.runtime.profiling import TRACER

SIZE = 64

# keyword of generate_dswx_layers -> file name, in the reference's order
VRT_LAYERS = [('output_dem_layer', 'DEM'), ('output_shadow_layer', 'SHAD'),
              ('output_landcover', 'LAND'),
              ('output_diagnostic_layer', 'DIAG'),
              ('output_non_masked_dswx', 'WTR-1'),
              ('output_shadow_masked_dswx', 'WTR-2'),
              ('output_interpreted_band', 'WTR'),
              ('output_cloud_layer', 'CLOUD'),
              ('output_binary_water', 'BWTR'),
              ('output_confidence_layer', 'CONF')]
RGB_LAYERS = [('output_rgb_file', 'RGB'),
              ('output_infrared_rgb_file', 'infrared RGB')]
FILES = [name for _, name in VRT_LAYERS + RGB_LAYERS] + ['BROWSE',
                                                        'BROWSE.png']
SAVES = ('save_array', 'save_dswx_product', 'save_cloud_layer',
         'save_binary_water', 'save_output_rgb_file')


@pytest.fixture(scope='module')
def tile(tmp_path_factory):
    root = tmp_path_factory.mktemp('saves_tile')
    d = str(root / 'hls')
    synthetic.make_hls_v2_dataset(d, size=SIZE, seed=321)
    anc = dict(dem_file=synthetic.make_dem(str(root), size=SIZE),
               landcover_file=synthetic.make_landcover(str(root), size=SIZE),
               worldcover_file=synthetic.make_worldcover(str(root),
                                                         size=SIZE))
    return sorted(glob.glob(os.path.join(d, '*.tif'))), anc


def _outputs(out, rgb=True):
    layers = VRT_LAYERS + (RGB_LAYERS if rgb else [])
    kw = {key: os.path.join(out, f'{name.replace(" ", "_")}.tif')
          for key, name in layers}
    kw['output_browse_image'] = os.path.join(out, 'BROWSE.png')
    return kw


def _run(tile, out, product_id='tile_a', **kwargs):
    inputs, anc = tile
    return orch.generate_dswx_layers(
        inputs, **anc, scratch_dir=os.path.join(out, 'scratch'),
        product_id=product_id, check_ancillary_inputs_coverage=False,
        device=torch.device('cpu'), **kwargs)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope='module')
def product(tile, tmp_path_factory):
    """One product run with every output on and a VRT, each save function
    recorded (its outermost call a file: function, arguments, end time);
    the DEM's file is held back 0.3 s so that it finishes late."""
    out = str(tmp_path_factory.mktemp('saves_product'))
    outputs = _outputs(out)
    calls, lock = {}, threading.Lock()

    def record(name, fn):
        def wrapped(*args, **kwargs):
            path = args[1] if name == 'geotiff2png' else next(
                a for a in args if isinstance(a, str) and a.endswith('.tif'))
            if path == outputs['output_dem_layer'] and 'payload' in kwargs:
                time.sleep(0.3)
            with lock:
                outer = path not in calls
                if outer:
                    calls[path] = [name, args, dict(kwargs), None]
            fn(*args, **kwargs)
            if outer:
                calls[path][3] = time.perf_counter()
        return wrapped

    logger = logging.getLogger('dswx_hls')
    handler, level = _Lines(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        with pytest.MonkeyPatch.context() as mp:
            for name in SAVES:
                mp.setattr(pw, name, record(name, getattr(pw, name)))
            mp.setattr(orch, 'geotiff2png',
                       record('geotiff2png', orch.geotiff2png))
            assert _run(tile, out, output_file=os.path.join(out, 'P.vrt'),
                        **outputs) is True
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    return out, outputs, calls, handler.lines


def _path(outputs, name):
    if name == 'BROWSE':
        return outputs['output_browse_image'].replace('.png', '.tif')
    if name == 'BROWSE.png':
        return outputs['output_browse_image']
    key = dict((n, k) for k, n in VRT_LAYERS + RGB_LAYERS)[name]
    return outputs[key]


@pytest.mark.parametrize('name', FILES)
def test_each_file_is_what_its_save_writes_alone(product, tmp_path, name):
    """The file the pool wrote against the same save function called alone
    afterwards, with the arguments the run gave it (no payload, no output
    list): the same bytes; and its metadata is the final one."""
    _, outputs, calls, _ = product
    path = _path(outputs, name)
    fn_name, args, kwargs, _ = calls[path]
    kwargs.pop('payload', None)
    kwargs.pop('output_files_list', None)
    alone = str(tmp_path / os.path.basename(path))
    if name == 'BROWSE.png':
        # the PNG of the browse COG written alone
        tif = str(tmp_path / 'browse_alone.tif')
        with open(tif, 'wb') as fh, open(args[0], 'rb') as src:
            fh.write(src.read())
        args = (tif, alone) + args[2:]
        getattr(orch, fn_name)(*args, **kwargs)
    else:
        getattr(pw, fn_name)(*[alone if isinstance(a, str) and a == path else a
                               for a in args],
                             **kwargs)
        assert validate_cog(path, full_check=True) == []
        with TiffReader(path) as r:
            md = r.metadata()
        for key in ('SPATIAL_COVERAGE', 'CLOUD_COVERAGE',
                    'SPATIAL_COVERAGE_EXCLUDING_MASKED_OCEAN'):
            assert key in md
    with open(path, 'rb') as a, open(alone, 'rb') as b:
        assert a.read() == b.read()


def test_every_file_gets_its_own_metadata(product):
    _, _, calls, _ = product
    metas = [a for _, args, _, _ in calls.values() for a in args
             if isinstance(a, dict) and 'SPATIAL_COVERAGE' in a]
    # one a save; the browse's PNG takes none
    assert len(metas) == len(FILES) - 1
    assert len({id(m) for m in metas}) == len(metas)
    assert all(m == metas[0] for m in metas)


def test_output_lists_and_vrt_keep_the_reference_order(product, tmp_path):
    out, outputs, calls, lines = product
    members = [_path(outputs, n) for _, n in VRT_LAYERS]
    # the files did not finish in the reference's order
    finished = sorted(members, key=lambda m: calls[m][3])
    assert finished.index(outputs['output_dem_layer']) > 2
    vrt = os.path.join(out, 'P.vrt')
    standalone = [_path(outputs, n) for _, n in RGB_LAYERS] + [
        _path(outputs, 'BROWSE'), _path(outputs, 'BROWSE.png')]
    at = lines.index('output files:')
    logged = [line[4:] for line in lines[at + 1:at + 1 + len(members) + 1
                                         + len(standalone)]]
    assert logged == members + [vrt] + standalone
    build_vrt(str(tmp_path / 'expected.vrt'), members)
    with open(vrt) as a, open(tmp_path / 'expected.vrt') as b:
        assert a.read() == b.read()


def _pool_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith('sas.save')]


@pytest.mark.parametrize('where', ['file', 'payload', 'chain'])
def test_a_failure_raises_and_leaves_no_pool_thread(tile, tmp_path,
                                                    monkeypatch, where):
    """A CLOUD save, the DEM's early payload, or the chain after the early
    payloads started: the run raises that error, and the pool's threads
    are gone."""
    def boom(*args, **kwargs):
        raise RuntimeError(f'forced failure in the {where}')
    if where == 'file':
        monkeypatch.setattr(pw, 'save_cloud_layer', boom)
    elif where == 'payload':
        monkeypatch.setattr(pw, 'layer_payload', boom)
    else:
        monkeypatch.setattr(orch, 'wtr_layers', boom)
    with pytest.raises(RuntimeError, match=f'forced failure in the {where}'):
        _run(tile, str(tmp_path), **_outputs(str(tmp_path), rgb=False))
    assert _pool_threads() == []


def test_counters_count_early_payloads_and_pooled_saves(tile, tmp_path):
    """Two products of the same input: 3 early payloads and one pooled
    save a COG file each, every save's wait in the queue a span, one join,
    and no COG payload cache hit."""
    for k in range(2):
        out = str(tmp_path / f'p{k}')
        TRACER.start()
        try:
            assert _run(tile, out, product_id=f'tile_{k}',
                        **_outputs(out, rgb=False)) is True
        finally:
            got = TRACER.stop()
        cogs = glob.glob(os.path.join(out, '*.tif'))
        assert len(cogs) == len(VRT_LAYERS) + 1   # and the browse's
        assert got.counters['save.early'] == 3
        assert got.counters['save.pooled'] == len(cogs)
        assert 'cog_payload.hit' not in got.counters
        names = [s.name for s in got.spans]
        assert names.count('save.queued') == 3 + len(cogs)
        assert names.count('save.join') == 1
        assert sorted(n for n in names if n.startswith('payload ')) == \
            ['payload DEM', 'payload LAND', 'payload SHAD']
    assert _pool_threads() == []


def test_campaign_dem_payload_is_reused_on_a_revisit(tmp_path):
    """The campaign's writer (``_write_tile``) keeps the COG payload cache
    after ``write_cog``'s split: two tiles of one grid encode the DEM
    once, and each file holds the DEM and its own metadata."""
    cog.PAYLOAD_CACHE.clear()
    dem = np.linspace(0, 800, 96 * 96, dtype=np.float32).reshape(96, 96)
    science = {name: np.zeros((96, 96), np.uint8)
               for name in ('WTR', 'BWTR', 'CONF', 'WTR-1', 'WTR-2',
                            'CLOUD')}
    science['DIAG'] = np.zeros((96, 96), np.uint16)
    base = dict(geotransform=(600000, 30, 0, 4500000, 0, -30),
                projection='EPSG:32615', length=96, width=96)
    TRACER.start()
    try:
        for i in range(2):
            job = campaign.TileJob(f't{i}', [], str(tmp_path / f't{i}'))
            image_dict = dict(base, dem=dem,
                              dem_payload_key=('dem_warp', 'sig',
                                               base['geotransform'],
                                               base['projection'],
                                               96, 96, 0))
            campaign._write_tile(job, dict(science), image_dict,
                                 {'SENSING_TIME': f'T{i}'})
    finally:
        got = TRACER.stop()
        cog.PAYLOAD_CACHE.clear()
    assert got.counters['cog_payload.miss'] == 1
    assert got.counters['cog_payload.hit'] == 1
    for i in range(2):
        (tif,) = glob.glob(str(tmp_path / f't{i}' / '*_DEM.tif'))
        assert validate_cog(tif, full_check=True) == []
        with TiffReader(tif) as r:
            np.testing.assert_array_equal(r.read(), dem)
            assert r.metadata()['SENSING_TIME'] == f'T{i}'
