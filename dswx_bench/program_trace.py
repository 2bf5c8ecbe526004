"""A traced run with the program's own tracer: its capture over the window,
placed on the trace's time line by a fitted clock, and the device's idle
gaps named by what the program was doing.

    python -m dswx_bench.program_trace --workload <name> --seed <n> --seconds <s>

runs one ``--trace 1`` run of a cell (``run.run_cell``), with the
program's tracer (``proteus_tpu_torch.runtime.profiling.TRACER``)
capturing inside the entry's window, and reports beside the run's own
lines and result:

- the record's new keys: ``program_spans`` (every span of every thread
  over the window), ``program_counters`` (the counters' change over it)
  and ``process_cpu_s`` (``resource.getrusage`` over it, so that work on
  threads no span sees shows as the difference);
- the metrics of ``PROGRAM_METRICS`` (``metrics/<name>.py``) and the
  end-to-end ones, read from that record;
- ``clock_map``: trace us = a + b * perf_counter us, fitted on the spans
  the profiler's thread stamped on both clocks, and its worst residual;
- ``span_coverage``: the share of the window the main thread's program
  spans cover;
- ``trace_copy_bytes``: the bytes on the trace's host-to-device and
  device-to-host copies over the window, beside the counted ones;
- ``idle_gaps_program``: the longest idle gaps, each named by the main
  thread's innermost program span and then, after ' | ', the innermost
  spans of the other threads with their thread counts;
- ``span_totals``: count, wall seconds and thread CPU seconds a span name.

On a program without the tracer the run is the plain traced run, and
these lines read null.

This module is temporary. Nothing here is read by ``python -m dswx_bench``,
since it only adds to the harness: it swaps ``entries.load`` for entries
whose ``window`` runs under the capture, and keeps the six metrics'
``per_layer`` entries itself (``PROGRAM_METRICS``). Wiring them in is a
change of the harness's own files: ``capturing`` into ``entries/``,
``fit_clock`` and ``gap_label`` into ``trace.py``, ``PROGRAM_METRICS``
into ``BENCHMARK.json``; this module then goes, and with it the
harness's ``counting_misses``, its ``annotate`` wrappers and its parse of
the SAS's log lines.
"""

import argparse
import collections
import json
import os
import resource
import sys

from dswx_bench import entries, registry, run
from dswx_bench import trace as tr

PROGRAM_METRICS = [
    {'name': 'read_wait_s_per_tile.campaign', 'unit': 's',
     'better': 'lower', 'source': 'program_span', 'layer': 'reader pool',
     'moves': 'tiles_per_gpu_hour', 'workloads': ['campaign_timeseries']},
    {'name': 'read_cpu_s_per_tile.campaign', 'unit': 's',
     'better': 'lower', 'source': 'program_span', 'layer': 'reader pool',
     'moves': 'tiles_per_gpu_hour', 'workloads': ['campaign_timeseries']},
    {'name': 'write_cpu_s_per_tile.campaign', 'unit': 's',
     'better': 'lower', 'source': 'program_span', 'layer': 'writer pool',
     'moves': 'tiles_per_gpu_hour', 'workloads': ['campaign_timeseries']},
    {'name': 'h2d_mib_per_tile.campaign', 'unit': 'MiB', 'better': 'lower',
     'source': 'program_counter', 'layer': 'device',
     'moves': 'tiles_per_gpu_hour', 'workloads': ['campaign_timeseries']},
    {'name': 'anc_cache_misses_per_tile.campaign', 'unit': 'misses',
     'better': 'lower', 'source': 'program_counter',
     'layer': 'reader pool and ancillary cache',
     'moves': 'tiles_per_gpu_hour', 'workloads': ['campaign_timeseries']},
    {'name': 'h2d_mib_per_tile.sas', 'unit': 'MiB', 'better': 'lower',
     'source': 'program_counter', 'layer': 'device',
     'moves': 'tile_latency_s', 'workloads': ['sas_single_tile']},
]
LABEL_CHARS = 120


def _program_profiling():
    """The program's ``runtime.profiling`` if it has the tracer, else
    None."""
    try:
        from proteus_tpu_torch.runtime import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, 'TRACER') else None


def _cpu_s():
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def capturing(entry_class, box):
    """``entry_class`` with its window run under an anchored capture of
    the program's tracer; the window's dict gains ``program_spans``,
    ``program_counters`` and ``process_cpu_s``, and ``box['capture']``
    holds the capture."""
    profiling = _program_profiling()
    if profiling is None:
        return entry_class

    class Captured(entry_class):
        def window(self, seconds):
            cpu0 = _cpu_s()
            profiling.TRACER.start(anchors=True)
            try:
                out = super().window(seconds)
            finally:
                capture = profiling.TRACER.stop()
            box['capture'] = capture
            box['process_cpu_s'] = _cpu_s() - cpu0
            return dict(out, program_spans=capture.records(),
                        program_counters=capture.counters,
                        process_cpu_s=box['process_cpu_s'])
    return Captured


def fit_clock(pairs, dropped=0):
    """Least squares of trace us = a + b * host us over ``pairs`` ((host
    us, trace us)): {'a', 'b', 'pairs', 'dropped', 'worst_residual_us'},
    or None with fewer than two distinct host times. ``dropped`` is
    reported as given (the pairs left out before the fit)."""
    if len(pairs) < 2:
        return None
    n = len(pairs)
    mx = sum(x for x, _ in pairs) / n
    my = sum(y for _, y in pairs) / n
    sxx = sum((x - mx) ** 2 for x, _ in pairs)
    if sxx == 0:
        return None
    b = sum((x - mx) * (y - my) for x, y in pairs) / sxx
    a = my - b * mx
    worst = max(abs(y - (a + b * x)) for x, y in pairs)
    return {'a': a, 'b': b, 'pairs': n, 'dropped': dropped,
            'worst_residual_us': worst}


def annotations(path, skip=(tr.WINDOW_SPAN,)):
    """The ``user_annotation`` spans of a Chrome trace as (name, ts, dur),
    sorted by ts."""
    with open(path) as fh:
        events = json.load(fh)['traceEvents']
    return sorted(((e['name'], float(e['ts']), float(e['dur']))
                   for e in events if e.get('ph') == 'X'
                   and e.get('cat') == 'user_annotation'
                   and e['name'] not in skip), key=lambda a: a[1])


# a host time is the middle of the two reads around the profiler's stamp;
# wider than this (the thread lost the interpreter lock or its core
# between them), the pair is left out
BRACKET_US = 50.0


def anchor_pairs(spans, notes, bracket_us=BRACKET_US):
    """(pairs, dropped): the (host us, trace us) pairs of the anchored
    program spans (``spans``: records with ``anchor``, the host's reads
    around the profiler's stamps) and their annotations in the trace
    (``notes``: (name, ts, dur)), matched by name and order, a span giving
    its start and its end; a pair whose reads lie more than
    ``bracket_us`` apart is dropped."""
    trace_of = collections.defaultdict(list)
    for name, ts, dur in notes:
        trace_of[name].append((ts, dur))
    taken = collections.Counter()
    pairs, dropped = [], 0
    for s in sorted((s for s in spans if s.get('anchor')),
                    key=lambda s: s['anchor'][0]):
        k = taken[s['name']]
        if k >= len(trace_of[s['name']]):
            continue
        taken[s['name']] += 1
        ts, dur = trace_of[s['name']][k]
        a0, a1, b0, b1 = (t * 1e-3 for t in s['anchor'])
        for lo, hi, y in ((a0, a1, ts), (b0, b1, ts + dur)):
            if hi - lo > bracket_us:
                dropped += 1
            else:
                pairs.append(((lo + hi) / 2, y))
    return pairs, dropped


def place(spans, fit):
    """The program spans on the trace's time line: (name, ts, dur,
    thread); a span that waited in a queue (no thread) is left out."""
    return [(s['name'], fit['a'] + fit['b'] * s['start_ns'] * 1e-3,
             fit['b'] * (s['end_ns'] - s['start_ns']) * 1e-3, s['thread'])
            for s in spans if s['thread'] is not None]


def gap_label(inner, main):
    """What the program was doing in a gap, from ``inner`` ({thread: the
    name of its innermost span there}): the main thread's span, then
    after ' | ' at most three spans of the other threads, each with the
    number of threads in it, most first."""
    inner = dict(inner)
    label = inner.pop(main, 'no main span')
    if inner:
        counts = collections.Counter(inner.values())
        top = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:3]
        label += ' | ' + ', '.join(f'{n}×{c}' for n, c in top)
    return label if len(label) <= LABEL_CHARS \
        else label[:LABEL_CHARS - 3] + '...'


def idle_gaps(device, spans, main, window, top=10):
    """The ``top`` longest stretches of the window with no device
    operation, [[label, seconds], ...], labelled by ``gap_label``.
    ``trace.idle_gaps`` finds them and names each by the innermost span
    of each thread around its middle, joined by '+'; given each span's
    index as its name, it tells which spans those are."""
    indexed = [(str(k), ts, dur, thread)
               for k, (_, ts, dur, thread) in enumerate(spans)]
    out = []
    for found, seconds in tr.idle_gaps(device, indexed, window, top):
        inner = {} if found == 'no host span' else {
            spans[int(k)][3]: spans[int(k)][0] for k in found.split('+')}
        out.append([gap_label(inner, main), seconds])
    return out


def coverage(spans, thread, window):
    """The share of ``window`` that ``thread``'s spans cover."""
    covered = tr.merged([(ts, ts + dur) for _, ts, dur, th in spans
                         if th == thread], window)
    return sum(b - a for a, b in covered) / (window[1] - window[0])


def copy_bytes(path, window):
    """{'h2d', 'd2h': bytes on the trace's copies over ``window``, and
    how many of those copies carried a byte count}."""
    with open(path) as fh:
        events = json.load(fh)['traceEvents']
    out = {'h2d': 0, 'd2h': 0, 'h2d_copies': 0, 'h2d_copies_with_bytes': 0}
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') != 'gpu_memcpy' \
                or not window[0] <= float(e['ts']) < window[1]:
            continue
        kind = 'h2d' if 'HtoD' in e['name'] else \
            'd2h' if 'DtoH' in e['name'] else None
        if kind is None:
            continue
        nbytes = (e.get('args') or {}).get('bytes')
        if kind == 'h2d':
            out['h2d_copies'] += 1
            out['h2d_copies_with_bytes'] += nbytes is not None
        out[kind] += int(nbytes or 0)
    return out


def span_totals(spans):
    """{name: [count, wall s, thread CPU s]} of the program spans."""
    out = {}
    for s in spans:
        t = out.setdefault(s['name'], [0, 0.0, 0.0])
        t[0] += 1
        t[1] += (s['end_ns'] - s['start_ns']) * 1e-9
        t[2] += s['cpu_ns'] * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def traced_cell(workload, seed, seconds, device, config=None, mix=None,
                work=run.WORK):
    """One traced run of ``workload`` with the program's capture: (result,
    lines), the lines ending with the ones the module's doc lists."""
    bench = registry.benchmark()
    bench['per_layer'] = bench['per_layer'] + PROGRAM_METRICS \
        + bench['end_to_end']
    box = {}
    load = entries.load
    entries.load = lambda name: capturing(load(name), box)
    try:
        result, lines = run.run_cell(workload, seed, seconds, True, device,
                                     bench=bench, config=config, mix=mix,
                                     work=work)
    finally:
        entries.load = load
    heavy = ('program_spans',)
    for line in lines:
        if isinstance(line.get('window'), dict):
            line['window'] = {k: v for k, v in line['window'].items()
                              if k not in heavy}
    capture = box.get('capture')
    if capture is None:
        for key in ('program_counters', 'process_cpu_s', 'clock_map',
                    'span_coverage', 'trace_copy_bytes',
                    'idle_gaps_program', 'span_totals'):
            lines.append({key: None})
        return result, lines
    spans = capture.records()
    path = os.path.join(work, 'trace.json')
    with open(path) as fh:
        window = next((float(e['ts']), float(e['ts']) + float(e['dur']))
                      for e in json.load(fh)['traceEvents']
                      if e.get('name') == tr.WINDOW_SPAN
                      and e.get('ph') == 'X')
    fit = fit_clock(*anchor_pairs(spans, annotations(path)))
    lines.append({'program_counters': capture.counters})
    lines.append({'process_cpu_s': box['process_cpu_s']})
    lines.append({'clock_map': fit})
    if fit is not None:
        placed = place(spans, fit)
        device_ops = tr.read_trace(path)[1]
        lines.append({'span_coverage': {
            'main': coverage(placed, capture.thread, window)}})
        lines.append({'idle_gaps_program': idle_gaps(
            device_ops, placed, capture.thread, window)})
    lines.append({'trace_copy_bytes': dict(
        copy_bytes(path, window), counted_h2d=sum(
            v for k, v in capture.counters.items()
            if k.startswith('h2d_bytes.')))})
    lines.append({'span_totals': span_totals(spans)})
    return result, lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('a traced run needs a CUDA device', file=sys.stderr)
        return 2
    run.fixed_cache_dirs()
    result, lines = traced_cell(args.workload, args.seed, args.seconds,
                                'cuda')
    for line in lines:
        print(json.dumps(line), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
