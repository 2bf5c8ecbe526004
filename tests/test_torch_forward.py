"""Forward production through the port, held to the benchmark's plain
reference: the cell ``campaign_continental`` (configuration
``hls_forward_s30``, mix ``continental``) at a 64 px tile on the CPU.

The mix puts a pass's 8 granules of one date on 8 MGRS grids, 2 across
and 4 along, origins 3333 px apart on a 3660 px tile (neighbours overlap
by 327 px); here the offsets are scaled to the tile at the same ratio
(58 px on 64), so the grids still overlap and the mosaic stays small.
One traced run of the cell, with every product sampled, runs in a fresh
process: the harness refuses a process that has loaded JAX, which this
suite's conftest does.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from dswx_bench import generate, registry  # noqa: E402

CELL = 'campaign_continental'
SIZE = 64
STEP = 58           # 3333 px on a 3660 px tile, scaled to SIZE
FULL_STEP, FULL_SIZE = 3333, 3660
KINDS = ('dem_warp', 'landcover', 'shadow')

_RUN = r'''
import json, sys
from dswx_bench import run
from proteus_tpu_torch.parallel import campaign
from proteus_tpu_torch.runtime.profiling import COUNTERS, Counters
config, mix = json.loads(sys.argv[1])
before = COUNTERS.snapshot()
result, lines = run.run_cell(%r, 2 ** 35 + 23, 0.3, True, 'cpu',
                             config=config, mix=mix, work=sys.argv[2])
print(json.dumps({
    'result': result, 'lines': lines,
    'counters': Counters.delta(COUNTERS.snapshot(), before),
    'stage_calls': {k: v[1] for k, v in
                    campaign.STAGE_TIMES.totals.items()}}))
''' % CELL


def _tiny():
    """(config, mix) of the cell at SIZE with the offsets scaled to it:
    ``tiny`` of the benchmark's own CPU tests."""
    spec = importlib.util.spec_from_file_location(
        'dswx_bench_tests_conftest',
        os.path.join(REPO, 'dswx_bench', 'tests', 'conftest.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    config, mix = module.tiny(CELL, size=SIZE)
    mix['grid_offsets_px'] = [[STEP * c // FULL_STEP, STEP * r // FULL_STEP]
                              for c, r in mix['grid_offsets_px']]
    return config, mix


@pytest.fixture(scope='module')
def cell_run(tmp_path_factory):
    """One traced run of the tiny cell, every product sampled."""
    work = str(tmp_path_factory.mktemp('forward') / 'work')
    config, mix = _tiny()
    mix['sample_products'] = 99
    out = subprocess.run(
        [sys.executable, '-c', _RUN, json.dumps([config, mix]), work],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_scaled_offsets_keep_the_lattice():
    assert _tiny()[1]['grid_offsets_px'] == [
        [0, 0], [-STEP, 0], [0, STEP], [-STEP, STEP], [0, 2 * STEP],
        [-STEP, 2 * STEP], [0, 3 * STEP], [-STEP, 3 * STEP]]


def test_every_product_of_every_grid_is_correct(cell_run):
    result = cell_run['result']
    assert result['correct'], result['checks']
    assert result['attempted'] >= 8 and result['attempted'] % 8 == 0
    assert result['failed'] == 0
    assert all(c['value'] == 0 == c['limit']
               for c in result['checks'].values()), result['checks']
    sampled = [line['sampled'] for line in cell_run['lines']
               if 'sampled' in line]
    assert sampled == [result['attempted']]


def test_each_grid_misses_the_cache_once_a_pass(cell_run):
    """Every tile is on a grid of its own: a pass computes 8 DEM warps, 8
    LAND masks and 8 shadows, and nothing twice (no hit, no wait on
    another reader's computation), warm-up pass included."""
    passes = cell_run['result']['attempted'] // 8
    misses = cell_run['lines'][0]['ancillary_cache_misses']
    assert misses == {k: 8 * passes for k in KINDS}
    counters = cell_run['counters']
    for kind in KINDS:
        assert counters[f'anc.{kind}.miss'] == 8 * (passes + 1)
        assert counters.get(f'anc.{kind}.hit', 0) == 0
        assert counters.get(f'anc.{kind}.wait', 0) == 0


def test_every_product_pays_its_three_warps(cell_run):
    """The warps' host stages in the campaign's stage table: three warps
    a product (DEM, CGLS, WorldCover), each reading, building its lattice
    and copying its source once."""
    calls = cell_run['stage_calls']
    n = cell_run['result']['attempted']
    for stage in ('warp.read', 'warp.lattice', 'warp.source'):
        assert calls[stage] == 3 * n, (stage, calls)
    assert calls.get('warp.redecide', 0) <= 3 * n
    assert cell_run['counters']['warp.source_bytes'] > 0


def test_no_warp_stage_is_counted_as_a_read_or_a_write(cell_run):
    """The campaign's reader and writer metrics sum the ``read_`` and
    ``write_`` stages: the warps' own stages, nested inside the reader's,
    carry another prefix."""
    names = set(cell_run['stage_calls'])
    assert {n for n in names if n.startswith('warp')} == {
        n for n in names if n.startswith('warp.')}
    assert {n for n in names if n.startswith(('read_', 'write_'))} == {
        'read_ingest_decode', 'read_dem_shadow', 'read_landcover',
        'write_d2h_layers', 'write_cog_science', 'write_cog_land',
        'write_cog_shad', 'write_d2h_dem', 'write_cog_dem_float32',
        'write_browse'}


def test_the_cells_metrics_read_the_run(cell_run):
    metrics = cell_run['result']['metrics']
    read_s = metrics['warp_read_s_per_tile.continental']['value']
    host_s = metrics['warp_host_s_per_tile.continental']['value']
    assert 0 < read_s < host_s
    assert metrics['read_core_s_per_tile.campaign']['value'] > host_s / 3
    # the CPU's trace holds no warp kernel
    assert 'warp_kernel_roofline.continental' not in metrics


def _grids(size, step):
    config = registry.config('hls_forward_s30')
    mix = registry.traffic('continental')
    config['tile']['size'] = size
    mix['grid_offsets_px'] = [[step * c // FULL_STEP, step * r // FULL_STEP]
                              for c, r in mix['grid_offsets_px']]
    return config, mix, generate.grids(config['tile'], mix)


@pytest.mark.parametrize('size,step', [(FULL_SIZE, FULL_STEP),
                                       (SIZE, STEP)])
def test_eight_grids_overlap_as_on_the_mgrs_lattice(size, step):
    """8 distinct geotransforms, 2 across and 4 along, each side
    neighbour overlapping the next by the tile less the step."""
    config, _, grids = _grids(size, step)
    gts = [g['geotransform'] for g in grids]
    assert len(set(gts)) == 8
    px = config['tile']['pixel_m']
    xs = sorted({gt[0] for gt in gts})
    ys = sorted({gt[3] for gt in gts}, reverse=True)
    assert len(xs) == 2 and len(ys) == 4
    assert xs[1] - xs[0] == step * px
    assert all(a - b == step * px for a, b in zip(ys, ys[1:]))
    assert size - step == (327 if size == FULL_SIZE else 6)
    assert gts[0][0] == config['tile']['x0'] == xs[1]
    assert gts[0][3] == config['tile']['y0'] == ys[0]


def test_the_mosaic_covers_every_grid_with_its_margin(tmp_path):
    """The ancillaries made for the tiny cell cover each grid's corners
    (by the port's own projection), widened by the margin, to within a
    pixel of each raster."""
    from proteus_tpu_torch.geo.crs import CRS, transform_points
    config, mix = _tiny()
    inputs = generate.make_inputs(config, mix, 31, str(tmp_path), 'cpu',
                                  write=False)
    margin = config['ancillaries']['margin_deg']
    grids = {a.grid['geotransform']: a.grid for a in inputs.acquisitions}
    assert len(grids) == 8
    utm = CRS.from_epsg(config['tile']['epsg'])
    for (x0, dx, _, y0, _, dy), grid in grids.items():
        n = grid['size']
        lon, lat = transform_points(
            utm, CRS.from_epsg(4326), np.array([x0, x0 + n * dx] * 2),
            np.array([y0, y0, y0 + n * dy, y0 + n * dy]))
        for key, (_, array, gt) in inputs.ancillaries.items():
            rows, cols = array.shape
            lon0, step, _, lat1, _, neg = gt
            lon1, lat0 = lon0 + cols * step, lat1 + rows * neg
            assert lon0 <= lon.min() - margin + step, key
            assert lon.max() + margin <= lon1 + step, key
            assert lat0 <= lat.min() - margin + step, key
            assert lat.max() + margin <= lat1 + step, key


def test_the_full_mosaic_has_the_sizes_of_the_deployment():
    """At full size the mosaic spans about 2.8 deg of longitude by 4.3
    of latitude: the DEM about 10.1k x 15.5k, WorldCover about 33.6k x
    51.6k (worked out alone, no raster made)."""
    config, mix, grids = _grids(FULL_SIZE, FULL_STEP)
    anc = config['ancillaries']
    shapes = {}
    for key in ('dem', 'worldcover'):
        rows, cols, _ = generate.ancillary_grid(
            grids, anc['margin_deg'], anc[key]['resolution_deg'])
        shapes[key] = (rows, cols)
    assert 15000 < shapes['dem'][0] < 16000
    assert 9700 < shapes['dem'][1] < 10500
    assert 50000 < shapes['worldcover'][0] < 53000
    assert 32500 < shapes['worldcover'][1] < 35000
