"""The interval arithmetic and both roofline bounds against cases worked by
hand, and the metric readers on records made up for them."""

import pytest

from dswx_bench import registry, trace
from dswx_bench.counts import peaks, warp, wtr_kernel


def test_busy_share_by_hand():
    s = trace.busy_share([(0, 2), (1, 3), (5, 6)], (0, 10))
    assert (s['busy'], s['idle'], s['window']) == (4.0, 6.0, 10.0)
    assert s['idle_share'] == pytest.approx(0.6)
    # clipped to the window; an empty interval counts nothing
    s = trace.busy_share([(-5, 1), (9, 15), (4, 4)], (0, 10))
    assert s['busy'] == 2.0
    assert trace.busy_share([(2, 4), (3, 8)])['busy_share'] == 1.0
    with pytest.raises(ValueError):
        trace.busy_share([], None)


def test_idle_gaps_and_top_operations():
    device = [('k', 10.0, 10.0), ('copy', 25.0, 5.0), ('k', 60.0, 40.0)]
    spans = [('outer', 0.0, 100.0, 1), ('write', 30.0, 25.0, 1),
             ('read', 40.0, 15.0, 2)]
    gaps = trace.idle_gaps(device, spans, (0.0, 100.0))
    # gaps 0-10 (outer), 20-25 (outer), 30-60 (write, the innermost of
    # thread 1, and read of thread 2)
    assert [g[0] for g in gaps] == ['read+write', 'outer', 'outer']
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 10e-6, 5e-6])
    top = trace.top_operations(device)
    assert [t[0] for t in top] == ['k', 'copy']
    assert [t[1] for t in top] == pytest.approx([50e-6, 5e-6])
    assert trace.idle_gaps([], [], (0.0, 1.0)) == [['no host span', 1e-6]]


def test_per_pixel_kernel_bound_by_hand():
    # 18 B a pixel and 24 B a tile over 3.35 TB/s; 221 operations a pixel
    # over 67 TFLOP/s is less
    px = 3660 * 3660
    assert wtr_kernel.CAMPAIGN_OPS_PER_PX == 221
    by_bytes = (18 * px + 24) / 3.35e12
    assert 221 * px / 67e12 < by_bytes
    assert wtr_kernel.campaign_bound_s(1, px) == pytest.approx(by_bytes)
    assert wtr_kernel.campaign_bound_s(4, px) == pytest.approx(4 * by_bytes)


def test_warp_bound_by_hand():
    # nearest, 16 x 16 out of a 40 x 40 uint8 window at spacing 8: reads
    # min(1600, 256) elements, writes 256 x (1 + 1) bytes, and the lattice
    # of 4 float32 planes of 4 x 4 nodes
    nbytes = 256 * 1 + 256 * 2 + 4 * 4 * 4 * 4
    ops = warp._warp_ops('nearest', 0, False, 16, 16, 4)
    want = max(nbytes / peaks.PEAK_BYTES_PER_S, ops / peaks.PEAK_OPS_PER_S)
    assert warp.warp_bound_s('nearest', 40, 40, 1, 16, 16, 1, 8) == want
    # cubic reads the whole window as float32 and writes float32
    nbytes = 1600 * 4 + 256 * 5 + 4 * 4 * 4 * 4
    ops = warp._warp_ops('cubic', 0, False, 16, 16, 4)
    assert warp.warp_bound_s('cubic', 40, 40, 4, 16, 16, 4, 8) == max(
        nbytes / peaks.PEAK_BYTES_PER_S, ops / peaks.PEAK_OPS_PER_S)
    # the operations bound a warp at the product's shapes (PERF.md: the
    # DEM cubic 0.3624 ms, the WorldCover nearest 0.3097 ms)
    assert warp.warp_bound_s('cubic', 5000, 5000, 4, 3760, 3760, 4, 8) \
        == pytest.approx(0.36237e-3, rel=1e-4)
    assert warp.warp_bound_s('nearest', 15000, 15000, 1, 10980, 10980, 1,
                             32) == pytest.approx(0.30966e-3, rel=1e-4)


def _record(**kw):
    r = {'products': 4, 'attempted': 4, 'window_s': 10.0, 'chips': 1,
         'setup_s': 3.0, 'peak_bytes': 2 ** 31, 'grid': {'size': 100},
         'stage_seconds': None, 'stage_timers': None, 'trace': None}
    r.update(kw)
    return r


def test_end_to_end_readers():
    r = _record()
    assert registry.reader('tiles_per_gpu_hour')(r) == 4 * 3600 / 10
    assert registry.reader('tile_latency_s')(r) == 2.5
    assert registry.reader('peak_device_gib')(r) == 2.0
    assert registry.reader('peak_device_gib.campaign')(r) == 2.0
    assert registry.reader('setup_s')(r) == 3.0
    assert registry.reader('peak_device_gib')(_record(peak_bytes=0)) is None
    assert registry.reader('tile_latency_s')(_record(products=0)) is None


def test_per_layer_readers():
    stages = {'read_ingest_decode': 2.0, 'read_dem_shadow': 6.0,
              'write_cog_science': 8.0, 'batch_stage_h2d': 1.0}
    r = _record(stage_seconds=stages)
    assert registry.reader('read_core_s_per_tile.campaign')(r) == 2.0
    assert registry.reader('write_core_s_per_tile.campaign')(r) == 2.0
    timers = [{'ingest (HLS bands)': 0.5, 'DEM warp': 0.25,
               'terrain shadow': 0.125, 'landcover warps + LAND': 0.125,
               'layer saves (COG encode)': 2.0}] * 2
    r = _record(stage_timers=timers)
    assert registry.reader('ingest_s_per_tile.sas')(r) == 0.5
    assert registry.reader('ancillary_s_per_tile.sas')(r) == 0.5
    assert registry.reader('cog_write_s_per_tile.sas')(r) == 2.0
    # nothing to read: nothing reported
    for name in ('read_core_s_per_tile.campaign', 'ingest_s_per_tile.sas',
                 'wtr_kernel_roofline.campaign', 'device_idle_share.sas',
                 'warp_kernel_roofline.sas'):
        assert registry.reader(name)(_record()) is None


def test_roofline_and_idle_readers():
    bound = wtr_kernel.campaign_bound_s(4, 100 * 100)
    # the kernel ran for twice its bound, in two launches; a PyTorch kernel
    # beside it does not count
    device = [('void wtr_pixel_kernel<short, false, false, 8, false>(...)',
               0.0, bound * 1e6), ('wtr_pixel_kernel', 50.0, bound * 1e6),
              ('elementwise_kernel', 100.0, 10.0)]
    r = _record(trace={'window': (0.0, 1000.0), 'device': device,
                       'spans': []})
    assert registry.reader('wtr_kernel_roofline.campaign')(r) == \
        pytest.approx(50.0)
    busy = 2 * bound * 1e6 + 10.0
    assert registry.reader('device_idle_share.campaign')(r) == \
        pytest.approx(100.0 * (1 - busy / 1000.0))
