"""The readers of the program's spans and counters, the idle gaps named by
the program's spans, and a traced run with the program's capture
(``program_trace.py``) at a small size on the CPU."""

import numpy as np
import pytest

from conftest import tiny
from dswx_bench import program_trace, registry

NEW = [m['name'] for m in program_trace.PROGRAM_METRICS]


def _span(name, start_s, end_s, cpu_s=0.0, thread='MainThread'):
    return {'name': name, 'id': 1, 'parent': None, 'thread': thread,
            'item': None, 'start_ns': int(start_s * 1e9),
            'end_ns': int(end_s * 1e9), 'cpu_ns': int(cpu_s * 1e9)}


def _record(**kw):
    r = {'products': 4, 'attempted': 4, 'window_s': 10.0, 'chips': 1,
         'setup_s': 3.0, 'peak_bytes': 0, 'stage_seconds': None,
         'stage_timers': None, 'trace': None}
    r.update(kw)
    return r


def test_program_metrics_read_a_record():
    spans = [_span('campaign.wait_read', 0, 1.5),
             _span('campaign.wait_read', 2, 2.5),
             _span('read_ingest_decode', 0, 2, 1.0, 'r1'),
             _span('read_landcover', 0, 4, 3.0, 'r2'),
             _span('campaign.read', 0, 5, 4.5, 'r1'),
             _span('write_cog_science', 0, 3, 2.0, 'w1'),
             _span('cog.encode', 0, 1, 8.0, 'w1')]
    counters = {'h2d_bytes.stack': 3 * 2 ** 20, 'h2d_bytes.warp_source':
                2 ** 20, 'd2h_bytes.write': 2 ** 30, 'anc.dem_warp.miss': 2,
                'anc.shadow.miss': 4, 'anc.shadow.hit': 9,
                'cog_payload.miss': 7}
    r = _record(program_spans=spans, program_counters=counters)
    want = {'read_wait_s_per_tile.campaign': 0.5,
            'read_cpu_s_per_tile.campaign': 1.0,
            'write_cpu_s_per_tile.campaign': 0.5,
            'h2d_mib_per_tile.campaign': 1.0,
            'h2d_mib_per_tile.sas': 1.0,
            'anc_cache_misses_per_tile.campaign': 1.5}
    assert sorted(want) == sorted(NEW)
    for name, value in want.items():
        assert registry.reader(name)(r) == pytest.approx(value), name


@pytest.mark.parametrize('name', NEW)
def test_program_metrics_read_nothing_without_the_program(name):
    """A record of a program without the tracer has neither key (or
    None): the metric is left out, and nothing raises."""
    read = registry.reader(name)
    assert read(_record()) is None
    assert read(_record(program_spans=None, program_counters=None)) is None
    assert read(_record(program_spans=[], program_counters=None,
                        products=0)) is None


def test_gap_labels_name_the_main_thread_then_the_others():
    # (name, ts, dur, thread) in trace microseconds
    spans = [('campaign.run', 0, 1000, 'main'),
             ('campaign.wait_read', 100, 800, 'main'),
             ('campaign.write', 0, 1000, 'w1'),
             ('write_cog_science', 50, 900, 'w1'),
             ('cog.encode', 60, 800, 'w1'),
             ('write_cog_science', 0, 1000, 'w2'),
             ('cog.encode', 0, 1000, 'w3'),
             ('read_landcover', 0, 1000, 'r1'),
             ('read_landcover', 0, 1000, 'r2'),
             ('write_cog_science', 0, 1000, 'w4')]
    assert program_trace.gap_label(
        {'main': 'campaign.wait_read', 'w1': 'cog.encode', 'w3': 'cog.encode',
         'r1': 'read_landcover', 'r2': 'read_landcover', 'w2': 'x',
         'w4': 'x', 'w5': 'write_cog_science'}, 'main') == (
        'campaign.wait_read | cog.encode×2, read_landcover×2, x×2')
    assert program_trace.gap_label({'main': 'campaign.run'}, 'main') \
        == 'campaign.run'
    assert program_trace.gap_label({'w1': 'campaign.write'}, 'main') == (
        'no main span | campaign.write×1')
    many = {f't{k}': f'stage_{"x" * 60}_{k}' for k in range(3)}
    assert len(program_trace.gap_label(many, 'main')) <= 120
    # the gaps: device busy 0-100 and 900-1000 us of a 0-1000 window, the
    # gap's middle at 500 us; then 0-800 and 960-1000, the middle at 880
    # us, past cog.encode on w1 but inside its write_cog_science
    device = [('k', 0.0, 100.0), ('k', 900.0, 100.0)]
    (gap,) = program_trace.idle_gaps(device, spans, 'main', (0.0, 1000.0))
    assert gap[0] == ('campaign.wait_read | cog.encode×2, '
                      'read_landcover×2, write_cog_science×2')
    assert gap[1] == pytest.approx(800e-6)
    device = [('k', 0.0, 800.0), ('k', 960.0, 40.0)]
    (gap,) = program_trace.idle_gaps(device, spans, 'main', (0.0, 1000.0))
    assert gap[0] == ('campaign.wait_read | write_cog_science×3, '
                      'read_landcover×2, cog.encode×1')
    assert gap[1] == pytest.approx(160e-6)
    (gap,) = program_trace.idle_gaps(device, [], 'main', (0.0, 1000.0))
    assert gap[0] == 'no main span'
    assert program_trace.coverage(spans, 'main', (0.0, 2000.0)) == 0.5


def test_a_traced_run_with_the_programs_capture(work):
    config, mix = tiny('campaign_timeseries', acquisitions=2)
    result, lines = program_trace.traced_cell(
        'campaign_timeseries', 2 ** 40 + 17, 0.3, 'cpu', config=config,
        mix=mix, work=work)
    assert result['correct']
    metrics = result['metrics']
    for name in NEW:
        if name.endswith('.campaign'):
            assert name in metrics, name
    assert 'h2d_mib_per_tile.sas' not in metrics
    assert metrics['h2d_mib_per_tile.campaign']['value'] == 0.0  # the CPU
    assert 'tiles_per_gpu_hour' in metrics
    got = {k: v for line in lines for k, v in line.items()}
    assert got['clock_map']['pairs'] > 10
    assert got['clock_map']['worst_residual_us'] < 1000.0
    assert got['span_coverage']['main'] > 0.9
    misses = {k.split('.')[1]: v for k, v in
              got['program_counters'].items() if k.endswith('.miss')
              and k.startswith('anc.')}
    assert misses == got['ancillary_cache_misses']
    assert got['process_cpu_s'] > 0
    assert all('program_spans' not in line.get('window', {})
               for line in lines if isinstance(line.get('window'), dict))


def test_a_program_without_the_tracer_runs_plain(work, monkeypatch):
    monkeypatch.setattr(program_trace, '_program_profiling', lambda: None)
    config, mix = tiny('sas_single_tile')
    result, lines = program_trace.traced_cell(
        'sas_single_tile', 2 ** 35 + 3, 0.2, 'cpu', config=config, mix=mix,
        work=work)
    assert result['correct']
    assert not set(NEW) & set(result['metrics'])
    got = {k: v for line in lines for k, v in line.items()}
    assert got['clock_map'] is None and got['program_counters'] is None


def test_anchor_pairs_match_by_name_and_drop_wide_brackets():
    spans = [{'name': 'a', 'anchor': [1000, 3000, 9000, 11000]},
             {'name': 'a', 'anchor': [20000, 22000, 30000, 130000]},
             {'name': 'b'}, {'name': 'c', 'anchor': [0, 10, 20, 30]}]
    notes = [('a', 5.0, 7.0), ('a', 25.0, 10.0), ('x', 1.0, 1.0)]
    pairs, dropped = program_trace.anchor_pairs(spans, notes)
    # the second span's end lay 100 us between its reads: left out
    assert pairs == [(2.0, 5.0), (10.0, 12.0), (21.0, 25.0)]
    assert dropped == 1
    fit = program_trace.fit_clock(pairs, dropped)
    assert fit['dropped'] == 1 and fit['pairs'] == 3


def test_fit_clock_recovers_offset_and_slope():
    rng = np.random.default_rng(5)
    host = np.sort(rng.uniform(1e3, 5e7, 200))
    a, b = 1.7e12, 1.000021
    noise = rng.uniform(-3.0, 3.0, host.size)
    fit = program_trace.fit_clock(list(zip(host, a + b * host + noise)))
    assert fit['pairs'] == 200
    # +-3 us of noise over 50 s: the slope to 1e-7, the offset to 10 us
    assert fit['b'] == pytest.approx(b, abs=1e-7)
    assert fit['a'] == pytest.approx(a, abs=10.0)
    assert fit['worst_residual_us'] <= 6.0
    # a pair 500 us off shows in the residual
    y = a + b * host
    y[100] += 500.0
    assert program_trace.fit_clock(list(zip(host, y)))[
        'worst_residual_us'] > 450.0
    assert program_trace.fit_clock([(1.0, 2.0)]) is None
    assert program_trace.fit_clock([(1.0, 2.0), (1.0, 3.0)]) is None


def test_anchored_capture_fits_the_trace_clock(tmp_path):
    """The program's anchored capture under ``torch.profiler``, as
    ``capturing`` runs it: the fit of its anchors to the trace's
    annotations leaves residuals well under a millisecond."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from proteus_tpu_torch.runtime.profiling import TRACER
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TRACER.start(anchors=True)
        try:
            for _ in range(20):
                with TRACER.span('stage'):
                    torch.ones(2 ** 16).cumsum(0)
                    with TRACER.span('inner'):
                        torch.ones(64).sum()
        finally:
            capture = TRACER.stop()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    spans = capture.records()
    pairs, dropped = program_trace.anchor_pairs(
        spans, program_trace.annotations(path))
    fit = program_trace.fit_clock(pairs, dropped)
    assert fit['pairs'] + fit['dropped'] == 84 and fit['pairs'] > 42
    assert fit['b'] == pytest.approx(1.0, abs=1e-3)
    assert fit['worst_residual_us'] < 1000.0
