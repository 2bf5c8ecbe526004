"""The warps' host halves as stages and counters
(``proteus_tpu_torch/geo/warp.py``), and the benchmark's readers of them.

A small synthetic DEM, CGLS and WorldCover are warped onto a 64 px tile
on the CPU under a capture: each warp's ``warp.*`` stages nest under the
caller's span, ``warp.source_bytes`` counts the window as the reader
decoded it, and ``warp.ambiguous_px`` the pixels re-decided on the host.
The three metrics of the cell ``campaign_continental`` are read from
records made by hand.
"""

import importlib.util
import os
import re
import sys

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu_torch.geo import warp
from proteus_tpu_torch.io.tiff import TiffReader
from proteus_tpu_torch.runtime import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from dswx_bench import registry  # noqa: E402

TRACER = profiling.TRACER
SIZE = 64
CPU = torch.device('cpu')
HOST_STAGES = ('warp.read', 'warp.lattice', 'warp.source')


@pytest.fixture(scope='module')
def sources(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('warp_stages'))
    return {'dem': synthetic.make_dem(root, size=SIZE),
            'cgls': synthetic.make_landcover(root, size=SIZE),
            'worldcover': synthetic.make_worldcover(root, size=SIZE)}


# (source, resampler, scale of the grid, margin px)
CASES = [('dem', 'cubic', 1, 50), ('cgls', 'nearest', 1, 0),
         ('worldcover', 'nearest', 3, 0)]


def _spied(monkeypatch):
    """Record the shape and item size of every window the TIFF reader
    decodes, and the pixels each float64 block resamples."""
    seen = {'windows': [], 'resampled': 0}
    read = TiffReader.read

    def spy_read(self, *args, **kwargs):
        data = read(self, *args, **kwargs)
        seen['windows'].append((data.shape, data.dtype.itemsize))
        return data

    block = warp._resample_block

    def spy_block(fdata, valid, u, v, *args, **kwargs):
        seen['resampled'] += np.asarray(u).size
        return block(fdata, valid, u, v, *args, **kwargs)

    monkeypatch.setattr(TiffReader, 'read', spy_read)
    monkeypatch.setattr(warp, '_resample_block', spy_block)
    return seen


def _warp(fn, path, algorithm, scale, margin, **kw):
    gt = synthetic.geotransform()
    grid = (gt[0], gt[1] / scale, 0.0, gt[3], 0.0, gt[5] / scale)
    return fn(path, grid, f'EPSG:{synthetic.EPSG}', SIZE * scale,
              SIZE * scale, resample_algorithm=algorithm,
              margin_in_pixels=margin, **kw)


def _window_bytes(windows):
    (shape, itemsize), = windows
    return shape[0] * shape[1] * itemsize


@pytest.mark.parametrize('key,algorithm,scale,margin', CASES)
def test_device_warp_stages_nest_under_the_caller(sources, monkeypatch,
                                                  key, algorithm, scale,
                                                  margin):
    seen = _spied(monkeypatch)
    TRACER.start()
    try:
        with TRACER.span('caller', item='tile_1'):
            out = _warp(warp.warp_to_grid_device, sources[key], algorithm,
                        scale, margin, device=CPU)
    finally:
        got = TRACER.stop()
    assert out.shape == (SIZE * scale + 2 * margin,) * 2
    (caller,) = [s for s in got.spans if s.name == 'caller']
    stages = [s for s in got.spans if s.name != 'caller']
    names = [s.name for s in stages]
    assert names[:3] == list(HOST_STAGES)
    assert names[3:] == (['warp.redecide'] if seen['resampled'] else [])
    for s in stages:
        assert s.parent == caller.span_id and s.item == 'tile_1'
        assert caller.start_ns <= s.start_ns <= s.end_ns <= caller.end_ns
    assert got.counters['warp.source_bytes'] == _window_bytes(
        seen['windows'])
    assert got.counters.get('warp.ambiguous_px', 0) == seen['resampled']


def test_the_cubic_dem_warp_redecides_pixels(sources, monkeypatch):
    """The DEM's cubic warp leaves ambiguous pixels to the host here, so
    the ``warp.redecide`` stage and its counter are exercised."""
    seen = _spied(monkeypatch)
    before = profiling.COUNTERS.snapshot()
    _warp(warp.warp_to_grid_device, sources['dem'], 'cubic', 1, 50,
          device=CPU)
    moved = profiling.Counters.delta(profiling.COUNTERS.snapshot(), before)
    assert seen['resampled'] > 0
    assert moved['warp.ambiguous_px'] == seen['resampled']


@pytest.mark.parametrize('key,algorithm,scale,margin', CASES)
def test_host_warp_stages_and_window_bytes(sources, monkeypatch, key,
                                           algorithm, scale, margin):
    seen = _spied(monkeypatch)
    TRACER.start()
    try:
        with TRACER.span('caller'):
            _warp(warp.warp_to_grid, sources[key], algorithm, scale, margin)
    finally:
        got = TRACER.stop()
    (caller,) = [s for s in got.spans if s.name == 'caller']
    stages = [s for s in got.spans if s.name != 'caller']
    # the host warp masks and casts its source before the lattice
    assert [s.name for s in stages] == ['warp.read', 'warp.source',
                                        'warp.lattice']
    assert all(s.parent == caller.span_id for s in stages)
    assert got.counters['warp.source_bytes'] == _window_bytes(
        seen['windows'])
    assert 'warp.ambiguous_px' not in got.counters


def test_stages_keep_the_campaigns_table_when_it_is_on(sources):
    table = profiling.STAGE_TIMES
    enabled = table.enabled
    table.reset()
    table.enabled = True
    try:
        _warp(warp.warp_to_grid_device, sources['cgls'], 'nearest', 1, 0,
              device=CPU)
    finally:
        table.enabled = enabled
    calls = {k: v[1] for k, v in table.totals.items()}
    table.reset()
    assert calls == {stage: 1 for stage in HOST_STAGES}


def test_with_no_capture_and_the_table_off_a_stage_is_the_shared_no_op(
        sources):
    table = profiling.STAGE_TIMES
    enabled = table.enabled
    table.enabled = False
    table.reset()
    try:
        assert not TRACER.capturing
        assert table.stage('warp.read') is profiling._OFF
        _warp(warp.warp_to_grid_device, sources['dem'], 'cubic', 1, 50,
              device=CPU)
        assert table.totals == {}
    finally:
        table.enabled = enabled


def test_no_warp_stage_name_starts_with_read_or_write():
    """The campaign's reader and writer metrics sum the stages named
    ``read_*`` and ``write_*``; the warps' stages nest inside the
    reader's and must not be counted twice."""
    with open(warp.__file__) as fh:
        names = re.findall(r"STAGE_TIMES\.stage\('([^']+)'\)", fh.read())
    assert set(names) == {*HOST_STAGES, 'warp.redecide'}
    assert not any(n.startswith(('read_', 'write_')) for n in names)


# ---- the benchmark's readers of the stages --------------------------------

def _record(**kw):
    r = {'products': 8, 'attempted': 8, 'stage_seconds': None,
         'trace': None}
    r.update(kw)
    return r


STAGES = {'read_dem_shadow': 20.0, 'read_landcover': 30.0,
          'warp.read': 4.0, 'warp.lattice': 2.0, 'warp.source': 1.2,
          'warp.redecide': 0.8, 'write_cog_science': 9.0}


def test_warp_read_s_reads_the_read_stage_a_product():
    read = registry.reader('warp_read_s_per_tile.continental')
    assert read(_record(stage_seconds=STAGES)) == pytest.approx(0.5)
    assert read(_record(stage_seconds={'warp.lattice': 1.0})) == 0.0


def test_warp_host_s_reads_every_warp_stage_a_product():
    read = registry.reader('warp_host_s_per_tile.continental')
    assert read(_record(stage_seconds=STAGES)) == pytest.approx(1.0)


@pytest.mark.parametrize('name', ['warp_read_s_per_tile.continental',
                                  'warp_host_s_per_tile.continental'])
def test_the_stage_readers_give_none_without_warp_stages(name):
    read = registry.reader(name)
    parent = {k: v for k, v in STAGES.items() if not k.startswith('warp.')}
    assert read(_record(stage_seconds=parent)) is None
    assert read(_record(stage_seconds=None)) is None
    assert read(_record(stage_seconds=STAGES, products=0)) is None


def _sas_module():
    spec = importlib.util.spec_from_file_location(
        'warp_kernel_roofline_sas', os.path.join(
            REPO, 'dswx_bench', 'metrics', 'warp_kernel_roofline.sas.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _roofline_record(device):
    """A record of the full-size cell: the first grid and the mosaic's
    shapes, as ``generate.py`` makes them (no raster made)."""
    from dswx_bench import generate
    config = registry.config('hls_forward_s30')
    grids = generate.grids(config['tile'], registry.traffic('continental'))
    anc = config['ancillaries']
    ancillaries = {}
    for key, itemsize in (('dem', 4), ('cgls', 1), ('worldcover', 1)):
        rows, cols, gt = generate.ancillary_grid(
            grids, anc['margin_deg'], anc[key]['resolution_deg'])
        ancillaries[key] = ((rows, cols), gt, itemsize)
    return _record(grid=grids[0], ancillaries=ancillaries, attempted=24,
                   processing={'dem_margin_px': 50},
                   trace={'window': (0.0, 5e7), 'device': device})


def test_the_roofline_is_the_bound_of_every_attempt_over_the_kernels():
    read = registry.reader('warp_kernel_roofline.continental')
    kernels = [
        ('void (anonymous namespace)::warp_nearest_kernel<unsigned char, '
         'int, 0>(...)', 10.0, 40000.0),
        ('void (anonymous namespace)::warp_kernel_kernel<4, 0, int, 0, '
         'float>(...)', 20.0, 20000.0),
        ('Memcpy HtoD (Pageable -> Device)', 30.0, 90000.0),
        ('void wtr_pixel_kernel<short>(...)', 40.0, 5000.0)]
    r = _roofline_record(kernels)
    bound = _sas_module().product_bound_s(r['grid'], r['ancillaries'], 50)
    assert 0 < bound < 0.01
    assert read(r) == pytest.approx(100.0 * bound * 24 / 0.06)


def test_the_roofline_gives_none_without_a_trace_or_a_warp_kernel():
    read = registry.reader('warp_kernel_roofline.continental')
    assert read(_roofline_record([])) is None
    assert read(_roofline_record(
        [('Memcpy HtoD (Pageable -> Device)', 1.0, 10.0)])) is None
    r = _roofline_record([])
    r['trace'] = None
    assert read(r) is None
