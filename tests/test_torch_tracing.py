"""The port's tracer (``runtime/profiling.py``), its spans and counters at
their sites, and the spans it stamps on the profiler's trace.

- with no capture, nothing is kept and neither torch nor its profiler is
  imported by the tracer;
- captured spans nest, carry their parent across pools, and hold the
  thread's CPU time;
- a CPU campaign of two passes keeps the stage table's keys and call
  counts, its ancillary misses are what the benchmark's
  ``counting_misses`` counts, and its spans place every read and write
  under the main thread's batches;
- a product run keeps the SAS breakdown's stage names and order, with its
  stages, its saves on the save pool, their early payloads, the join and
  the COG encodes as nested spans;
- the copy counters count a crossing of devices and nothing else; the
  COG payload cache and the kernel builds count theirs;
- an anchored capture stamps each span of its thread on the profiler's
  trace, and ``device_trace`` writes the product run's spans there.
"""

import glob
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu_torch import device as tdevice
from proteus_tpu_torch.io import cog
from proteus_tpu_torch.parallel import campaign
from proteus_tpu_torch.runtime import profiling
from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACER = profiling.TRACER
SIZE = 64


@pytest.fixture
def capture():
    """Start a capture; the test stops it (``TRACER.stop()``), or this
    fixture does after a failure."""
    TRACER.start()
    yield TRACER
    if TRACER.capturing:
        TRACER.stop()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# ---- the tracer -------------------------------------------------------------

_OFF_SCRIPT = r'''
import sys
from proteus_tpu_torch.runtime import profiling
T = profiling.TRACER
timers, table = profiling.StageTimers(), profiling.StageTimes()
table.enabled = True
assert T.span('x') is T.span('y')          # one shared no-op context
with T.span('x') as s, timers.stage('a'), table.stage('b'):
    assert s is None
    T.carry(len)('abc')
assert T._spans is None and not T.capturing
assert [n for n, _ in timers.stages] == ['a'] and table.totals['b'][1] == 1
bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')]
assert not bad, bad
print('OFF-OK')
'''


def test_no_capture_keeps_nothing_and_imports_no_profiler():
    """In a fresh process: spans, stages and carried functions with no
    capture keep no span, and load neither torch nor its profiler."""
    proc = subprocess.run([sys.executable, '-c', _OFF_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'OFF-OK' in proc.stdout


def _burn(seconds):
    t0 = time.perf_counter()
    x = 0
    while time.perf_counter() - t0 < seconds:
        x += 1
    return x


def test_spans_nest_and_carry_parents_across_pools(capture):
    with ThreadPoolExecutor(2) as pool:
        with TRACER.span('outer', item='tile_7') as outer:
            with TRACER.span('sleep'):
                time.sleep(0.05)

            def work():
                with TRACER.span('burn'):
                    _burn(0.05)
            futures = [pool.submit(TRACER.carry(work, queued='pool.queued'))
                       for _ in range(2)]
            for f in futures:
                f.result()
        assert outer.span_id > 0
    got = TRACER.stop()
    named = _by_name(got.spans)
    (o,) = named['outer']
    assert o.parent is None and o.item == 'tile_7'
    assert o.thread == threading.current_thread().name
    (s,) = named['sleep']
    assert s.parent == o.span_id and s.item == 'tile_7'
    # asleep, the thread spends next to no CPU
    assert s.cpu_ns < 0.5 * (s.end_ns - s.start_ns)
    burns = named['burn']
    assert len(burns) == 2
    for b in burns:
        assert b.parent == o.span_id and b.item == 'tile_7'
        assert b.thread != o.thread
        # busy, it spends its wall time on a CPU (give or take the host)
        assert b.cpu_ns > 0.2 * (b.end_ns - b.start_ns)
        assert o.start_ns <= b.start_ns <= b.end_ns <= o.end_ns
    queued = named['pool.queued']
    assert len(queued) == 2
    assert all(q.thread is None and q.parent == o.span_id and q.cpu_ns == 0
               and q.end_ns >= q.start_ns for q in queued)
    assert got.thread == threading.current_thread().name
    assert not TRACER.capturing
    # no anchors: no span entered the profiler's record_function
    assert not any(s.anchor for s in got.spans)


def test_a_second_capture_is_refused(capture):
    with pytest.raises(RuntimeError, match='already running'):
        TRACER.start()
    TRACER.stop()
    with pytest.raises(RuntimeError, match='no capture'):
        TRACER.stop()


def test_capture_returns_the_counters_that_moved(capture):
    profiling.COUNTERS.add('test.moved', 3)
    profiling.COUNTERS.add('test.moved')
    got = TRACER.stop()
    assert got.counters['test.moved'] == 4
    assert all(v != 0 for v in got.counters.values())


def test_counters_keep_every_increment_under_threads():
    """Eight threads add to one counter with a short switch interval:
    no increment is lost."""
    before = profiling.COUNTERS.snapshot().get('test.threads', 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(8) as pool:
            for f in [pool.submit(lambda: [profiling.COUNTERS.add(
                    'test.threads') for _ in range(2000)])
                    for _ in range(8)]:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.COUNTERS.snapshot()['test.threads'] - before == 16000


# ---- copies, caches, builds -------------------------------------------------

def test_copy_counters_count_only_crossings():
    def moved():
        return profiling.COUNTERS.snapshot()

    before = moved()
    t = torch.arange(12, dtype=torch.int16)
    same = tdevice.to_device(t, 'cpu', 'test_site')
    assert same is t
    a = tdevice.to_device(np.zeros((3, 5), np.float32), torch.device('cpu'),
                          'test_site')
    assert a.shape == (3, 5)
    assert tdevice.to_host(t, 'test_site') is not None
    assert profiling.Counters.delta(moved(), before) == {}
    meta = tdevice.to_device(t, 'meta', 'test_site')
    assert meta.device.type == 'meta'
    tdevice.to_device(np.ones(7, np.uint8), 'meta', 'test_site')
    assert tdevice.to_device(meta, 'meta', 'test_site') is meta
    assert profiling.Counters.delta(moved(), before) == {
        'h2d_bytes.test_site': 12 * 2 + 7}


def test_ancillary_cache_counts_hits_misses_and_waits(capture):
    cache = campaign._AncillaryCache(max_entries=4)
    release = threading.Event()

    def slow():
        release.wait(10)
        return 'v'

    with ThreadPoolExecutor(2) as pool:
        owner = pool.submit(cache.get, ('dem_warp', 1), slow)
        while ('dem_warp', 1) not in cache._entries:
            time.sleep(0.001)
        waiter = pool.submit(cache.get, ('dem_warp', 1), slow)
        time.sleep(0.05)
        release.set()
        assert owner.result(10) == waiter.result(10) == 'v'
    assert cache.get(('dem_warp', 1), slow) == 'v'
    assert cache.get(('landcover', 2), lambda: 'w') == 'w'
    got = TRACER.stop()
    assert {k: v for k, v in got.counters.items() if k.startswith('anc.')} \
        == {'anc.dem_warp.miss': 1, 'anc.dem_warp.wait': 1,
            'anc.dem_warp.hit': 1, 'anc.landcover.miss': 1}
    named = _by_name(got.spans)
    assert len(named['anc.dem_warp.compute']) == 1
    (wait,) = named['anc.dem_warp.wait']
    assert wait.end_ns - wait.start_ns > 0.02e9


def test_cog_payload_cache_counts_and_notes_the_encode(tmp_path, capture):
    """Each write is a ``cog.encode`` span; the payload cache counts its
    miss and its hit."""
    cog.PAYLOAD_CACHE.clear()
    arr = np.arange(64 * 64, dtype=np.float32).reshape(64, 64)
    key = cog.payload_cache_key(('dem', 'grid'), arr.shape, arr.dtype)
    for k in range(2):
        with cog.PAYLOAD_CACHE.claim(key) as claim:
            plans = claim.plans(lambda: cog.build_payload(arr))
        cog.write_cog(str(tmp_path / f'd{k}.tif'), None, epsg=4326,
                      payload=plans)
    got = TRACER.stop()
    cog.PAYLOAD_CACHE.clear()
    assert got.counters['cog_payload.miss'] == 1
    assert got.counters['cog_payload.hit'] == 1
    encodes = _by_name(got.spans)['cog.encode']
    assert len(encodes) == 2
    assert encodes[0].end_ns <= encodes[1].start_ns
    assert all(e.parent is None for e in encodes)


def test_kernel_builds_are_counted(monkeypatch):
    from proteus_tpu_torch.ops import build
    monkeypatch.setattr(build, '_LOADED', {})
    made = []

    def fake(name):
        made.append(name)
        return build.Built(f'/x/{name}.so', 1.25 if name == 'new' else 0.0,
                           '', None)
    monkeypatch.setattr(build, '_build', fake)
    before = profiling.COUNTERS.snapshot()
    for name in ('new', 'new', 'reused'):
        build.build(name)
    assert made == ['new', 'reused']
    moved = profiling.Counters.delta(profiling.COUNTERS.snapshot(), before)
    assert moved == {'kernels.loaded': 2, 'kernels.built': 1,
                     'kernels.build_ms': 1250}


# ---- the campaign -----------------------------------------------------------

# the stage table of the campaign below: four tiles a pass, two a batch,
# two passes, DEM and landcover, browse. Only the writer that builds a
# grid's DEM payload copies the DEM out: once a pass
PARENT_STAGE_CALLS = {
    'read_ingest_decode': 8, 'read_dem_shadow': 8, 'read_landcover': 8,
    'batch_stage_h2d': 4, 'batch_device_step_dispatch': 4,
    'write_d2h_layers': 8, 'write_cog_science': 8, 'write_cog_land': 8,
    'write_cog_shad': 8, 'write_d2h_dem': 2, 'write_cog_dem_float32': 8,
    'write_browse': 8}


@pytest.fixture(scope='module')
def grid(tmp_path_factory):
    root = tmp_path_factory.mktemp('tracing_tiles')
    dirs = []
    for t in range(4):
        d = str(root / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=SIZE, seed=900 + t)
        dirs.append(d)
    anc = dict(dem_file=synthetic.make_dem(str(root), size=SIZE),
               landcover_file=synthetic.make_landcover(str(root), size=SIZE),
               worldcover_file=synthetic.make_worldcover(str(root),
                                                         size=SIZE))
    return root, dirs, anc


def _campaign_passes(grid, out, passes=2):
    """``passes`` campaigns of the grid's four tiles from cleared caches,
    the stage table on: (stats of each pass, capture)."""
    _, dirs, anc = grid
    runner = campaign.CampaignRunner(
        mesh=[torch.device('cpu')], tiles_per_device=2, save_browse=True,
        manifest_path=os.path.join(out, 'manifest.json'))
    enabled = campaign.STAGE_TIMES.enabled
    campaign.STAGE_TIMES.reset()
    campaign.STAGE_TIMES.enabled = True
    TRACER.start()
    try:
        all_stats = []
        for p in range(passes):
            campaign.ANCILLARY_CACHE.clear()
            cog.PAYLOAD_CACHE.clear()
            jobs = [campaign.TileJob(
                f'tile_{t}.p{p}', sorted(glob.glob(os.path.join(d, '*.tif'))),
                os.path.join(out, f'p{p}', f'tile_{t}'),
                product_id=f'tile_{t}', **anc) for t, d in enumerate(dirs)]
            all_stats.append(runner.run(jobs))
    finally:
        got = TRACER.stop()
        campaign.STAGE_TIMES.enabled = enabled
    return all_stats, got


def test_campaign_keeps_its_stage_table(grid, tmp_path):
    stats, _ = _campaign_passes(grid, str(tmp_path))
    assert [s['tiles_done'] for s in stats] == [4, 4]
    table = campaign.STAGE_TIMES.table()
    calls = {k: v['calls'] for k, v in table.items()}
    # the warps' host stages nest inside the reads: a pass warps the DEM,
    # CGLS and WorldCover once; the re-decision runs where pixels are
    # ambiguous
    warps = {k: calls.pop(k) for k in list(calls) if k.startswith('warp.')}
    assert calls == PARENT_STAGE_CALLS
    assert {k: warps.pop(k) for k in ('warp.read', 'warp.lattice',
                                      'warp.source')} == dict.fromkeys(
        ('warp.read', 'warp.lattice', 'warp.source'), 6)
    assert set(warps) <= {'warp.redecide'} and sum(warps.values()) <= 6
    assert stats[-1]['stage_seconds'] == table
    assert campaign.STAGE_TIMES is profiling.STAGE_TIMES
    # the CPU crosses no device; every pass misses each ancillary kind
    # (the tiles share their sun, so one shadow a pass); the COG payloads
    # of the DEM and LAND are looked up once a tile and built once a pass
    # (whether a lookup is a hit or a wait depends on the threads' timing)
    for s in stats:
        assert not any(k.startswith(('h2d', 'd2h')) for k in s['counters'])
        assert {k: v for k, v in s['counters'].items()
                if k.startswith('anc.') and k.endswith('.miss')} == {
            'anc.dem_warp.miss': 1, 'anc.landcover.miss': 1,
            'anc.shadow.miss': 1}
        assert s['counters']['cog_payload.miss'] == 2
        assert sum(s['counters'].get(f'cog_payload.{k}', 0)
                   for k in ('hit', 'miss', 'wait')) == 8


def test_ancillary_misses_are_the_benchmarks_count(grid, tmp_path):
    """The program's miss counters on one run equal what the benchmark's
    ``counting_misses`` counts by replacing ``cache.get``."""
    from dswx_bench.entries.campaign import counting_misses
    with counting_misses(campaign.ANCILLARY_CACHE) as misses:
        _, got = _campaign_passes(grid, str(tmp_path))
    counted = {k.split('.')[1]: v for k, v in got.counters.items()
               if k.startswith('anc.') and k.endswith('.miss')}
    assert counted == misses and sum(counted.values()) == 6


def test_campaign_spans_place_reads_and_writes_under_batches(grid,
                                                             tmp_path):
    _, got = _campaign_passes(grid, str(tmp_path))
    spans = {s.span_id: s for s in got.spans}
    named = _by_name(got.spans)
    main = got.thread

    def ancestors(s):
        while s.parent is not None and s.parent in spans:
            s = spans[s.parent]
            yield s

    for name in ('campaign.run', 'campaign.batch', 'campaign.submit_reads',
                 'campaign.wait_read', 'batch_stage_h2d',
                 'campaign.step.launch', 'campaign.step.wait',
                 'campaign.submit_writes', 'campaign.wait_write'):
        assert named[name] and all(s.thread == main for s in named[name])
    assert len(named['campaign.batch']) == 4
    for s in named['campaign.step.launch'] + named['campaign.step.wait']:
        assert [a.name for a in ancestors(s)][:2] == [
            'batch_device_step_dispatch', 'campaign.batch']
    reads = named['campaign.read']
    assert len(reads) == 8 and all(r.thread != main for r in reads)
    assert all(spans[r.parent].name == 'campaign.submit_reads'
               for r in reads)
    # the prep pool's stages hang under their tile's read
    for s in named['read_dem_shadow'] + named['read_landcover']:
        (read,) = [a for a in ancestors(s) if a.name == 'campaign.read']
        assert read.item == s.item and s.item.startswith('tile_')
    assert {s.thread for s in named['read_dem_shadow']
            + named['read_landcover']} - {r.thread for r in reads}
    writes = named['campaign.write']
    assert len(writes) == 8
    for w in writes:
        assert 'campaign.batch' in [a.name for a in ancestors(w)]
        assert w.cpu_ns <= w.end_ns - w.start_ns + 10 ** 7
    queued = named['campaign.write.queued']
    assert sorted(q.item for q in queued) == sorted(w.item for w in writes)
    assert all(q.thread is None for q in queued)
    for s in named['cog.encode']:
        assert any(a.name.startswith('write_') for a in ancestors(s))


# ---- the product run --------------------------------------------------------

SAS_STAGES = ['ingest (HLS bands)', 'ancillary coverage checks', 'DEM warp',
              'terrain shadow', 'landcover warps + LAND',
              'device chain (compile+run)', 'device->host transfer',
              'layer saves (COG encode)']
SAS_SAVES = ['save DEM', 'save SHAD', 'save LAND', 'save DIAG', 'save WTR-1',
             'save WTR-2', 'save WTR', 'save BROWSE', 'save CLOUD',
             'save BWTR', 'save CONF']


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


# a line of ``StageTimers.report``'s table, as the parent writes it
BREAKDOWN_LINE = re.compile(r'^    (.{28}) +\d+\.\d\ds  +\d+\.\d%$')


def _breakdown(lines):
    """The stage names of the breakdown table in ``lines``, in order."""
    start = lines.index('stage timing breakdown:') + 1
    names = []
    for line in lines[start:]:
        m = BREAKDOWN_LINE.match(line)
        if not m:
            break
        names.append(m.group(1).rstrip())
    assert re.match(r'^    total {23} +\d+\.\d\ds$', lines[start + len(names)])
    return names


def test_product_run_keeps_its_breakdown_and_nests_its_spans(grid,
                                                            tmp_path):
    _, dirs, anc = grid
    names = ['output_interpreted_band', 'output_binary_water',
             'output_confidence_layer', 'output_diagnostic_layer',
             'output_non_masked_dswx', 'output_shadow_masked_dswx',
             'output_landcover', 'output_shadow_layer',
             'output_cloud_layer', 'output_dem_layer']
    outs = {n: str(tmp_path / f'{n}.tif') for n in names}
    logger = logging.getLogger('dswx_hls')
    handler, level = _Lines(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    TRACER.start()
    try:
        assert generate_dswx_layers(
            sorted(glob.glob(os.path.join(dirs[0], '*.tif'))), **anc,
            **outs, output_browse_image=str(tmp_path / 'BROWSE.png'),
            scratch_dir=str(tmp_path / 'scratch'), product_id='tile_0',
            check_ancillary_inputs_coverage=False,
            device=torch.device('cpu')) is True
    finally:
        got = TRACER.stop()
        logger.removeHandler(handler)
        logger.setLevel(level)
    assert _breakdown(handler.lines) == SAS_STAGES
    spans = {s.span_id: s for s in got.spans}
    named = _by_name(got.spans)
    (product,) = named['sas.product']
    assert product.parent is None and product.item == 'tile_0'
    for stage in SAS_STAGES:
        (s,) = named[stage]
        assert s.parent == product.span_id and s.item == 'tile_0'
    (saves,) = named['layer saves (COG encode)']
    # the saves run on the product's save pool, carried from the stage;
    # the payloads of DEM, SHAD and LAND start before it, under the product
    pooled = [s for s in got.spans if s.name.startswith('save ')]
    assert sorted(s.name for s in pooled) == sorted(SAS_SAVES)
    assert all(s.parent == saves.span_id and s.thread != got.thread
               for s in pooled)
    payloads = [s for s in got.spans if s.name.startswith('payload ')]
    assert sorted(s.name for s in payloads) == \
        ['payload DEM', 'payload LAND', 'payload SHAD']
    assert all(s.parent == product.span_id and s.thread != got.thread
               and s.end_ns <= saves.end_ns for s in payloads)
    (join,) = named['save.join']
    assert join.parent == saves.span_id and join.thread == got.thread
    assert all(s.end_ns <= join.end_ns for s in pooled)
    assert len(named['save.queued']) == len(pooled) + len(payloads)
    encodes = named['cog.encode']
    assert len(encodes) == len(SAS_SAVES)
    assert all(spans[e.parent].name.startswith('save ') for e in encodes)


# ---- the profiler's trace ---------------------------------------------------

def _annotations(path):
    with open(path) as fh:
        events = json.load(fh)['traceEvents']
    return [e for e in events if e.get('ph') == 'X'
            and e.get('cat') == 'user_annotation']


def test_anchored_capture_places_spans_on_the_trace(tmp_path):
    """An anchored capture under ``torch.profiler`` stamps each span of
    its thread on both clocks: every anchored span has its annotation in
    the trace, and its four reads of ``perf_counter_ns`` bracket the span
    in order. A pool's spans are kept but not anchored."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TRACER.start(anchors=True)
        try:
            with ThreadPoolExecutor(1) as pool:
                for _ in range(20):
                    with TRACER.span('stage'):
                        _burn(0.002)
                        with TRACER.span('inner'):
                            torch.ones(64).sum()
                pool.submit(TRACER.carry(
                    TRACER.traced('pooled')(_burn)), 0.001).result()
        finally:
            got = TRACER.stop()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    anchored = [s for s in got.spans if s.anchor]
    assert len(anchored) == 42    # 40 and the capture's start and stop
    assert sorted(e['name'] for e in _annotations(path)) == sorted(
        s.name for s in anchored)
    for s in anchored:
        a0, a1, b0, b1 = s.anchor
        assert a0 <= a1 <= s.start_ns <= s.end_ns <= b0 <= b1
    (pooled,) = _by_name(got.spans)['pooled']
    assert pooled.anchor is None and pooled.thread != got.thread


def test_device_trace_writes_the_product_runs_spans(tmp_path):
    """``device_trace`` (``PROTEUS_TPU_TRACE_DIR``) writes every span of
    its thread into the trace file, and leaves a capture that already
    runs to its owner."""
    with profiling.device_trace(str(tmp_path / 'a')) as trace:
        with TRACER.span('device chain (compile+run)'):
            with TRACER.span('inner'):
                torch.ones(64).sum()
    assert not TRACER.capturing
    names = [e['name'] for e in _annotations(trace.path)]
    assert sorted(names) == ['capture.start', 'capture.stop',
                             'device chain (compile+run)', 'inner']
    TRACER.start()
    try:
        with profiling.device_trace(str(tmp_path / 'b')) as trace:
            with TRACER.span('outer'):
                pass
        assert TRACER.capturing
    finally:
        got = TRACER.stop()
    assert [s.name for s in got.spans] == ['outer']
    assert not any(s.anchor for s in got.spans)
    with open(trace.path) as fh:
        assert 'traceEvents' in json.load(fh)
