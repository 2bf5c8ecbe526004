"""Tracing and per-stage timing.

- ``StageTimers`` (copied from ``proteus_tpu/runtime/profiling.py:21-48``):
  lightweight named wall-clock stage timers, logged as a breakdown table at
  the end of a product run;
- ``device_trace``: context manager around ``torch.profiler.profile`` (CPU
  and CUDA activities) that writes a Chrome trace (view with Perfetto or
  chrome://tracing); counterpart of ``proteus_tpu/runtime/profiling.py:
  51-61``, which wraps ``jax.profiler.trace``;
- ``Trace.annotate`` (on what ``device_trace`` yields):
  ``torch.profiler.record_function``, a named span inside a trace and
  nothing when tracing is off (counterpart of ``:64-67``);
- ``device_busy_share``: from a written trace, how long the device was
  busy and idle inside a window, and its top operations by total time.
  ``busy_share`` is the interval arithmetic under it.

This module imports nothing of ``torch`` or its profiler, and starts no
profiler, unless a trace directory is given, so a run without one pays
nothing for it.
"""

import contextlib
import json
import logging
import os
import time

logger = logging.getLogger('dswx_hls')

# categories of the Chrome trace's events that occupy the device
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


class StageTimers:
    def __init__(self):
        self.stages = []  # (name, seconds), ordered

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.append((name, time.perf_counter() - t0))

    def add(self, name, seconds):
        self.stages.append((name, seconds))

    def total(self):
        return sum(s for _, s in self.stages)

    def report(self, log=None):
        log = log or logger
        total = self.total()
        if not self.stages:
            return
        log.info('stage timing breakdown:')
        for name, s in self.stages:
            pct = 100.0 * s / total if total else 0.0
            log.info(f'    {name:<28} {s:8.2f}s  {pct:5.1f}%')
        log.info(f'    {"total":<28} {total:8.2f}s')


class Trace:
    """What ``device_trace`` yields: ``annotate(name)`` labels a span (a
    no-op when tracing is off), ``path`` is the trace file once the
    context has closed (None when tracing is off)."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.path = None

    def annotate(self, name):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


@contextlib.contextmanager
def device_trace(trace_dir):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is
    one, the CUDA device into a new Chrome trace file under ``trace_dir``
    (a no-op when ``trace_dir`` is falsy). Yields a ``Trace``."""
    trace = Trace(bool(trace_dir))
    if not trace_dir:
        yield trace
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield trace
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    trace.path = os.path.join(
        trace_dir, f'trace_{os.getpid()}_{time.time_ns()}.json')
    prof.export_chrome_trace(trace.path)
    logger.info(f'device trace written to: {trace.path}')


def busy_share(intervals, window=None):
    """The union of ``intervals`` ((start, end) pairs in one unit) inside
    ``window`` ((start, end); default: from the first start to the last
    end): a dict of ``window``, ``busy``, ``idle`` (in that unit) and
    ``busy_share``, ``idle_share`` (fractions of the window). Overlapping
    intervals count once."""
    spans = sorted((float(a), float(b)) for a, b in intervals if b > a)
    if window is None:
        if not spans:
            raise ValueError('busy_share: no interval and no window')
        window = (spans[0][0], max(b for _, b in spans))
    w0, w1 = float(window[0]), float(window[1])
    if w1 <= w0:
        raise ValueError(f'busy_share: empty window {window}')
    busy = 0.0
    cursor = w0
    for a, b in spans:
        a, b = max(a, cursor), min(b, w1)
        if b > a:
            busy += b - a
            cursor = b
    total = w1 - w0
    return {'window': total, 'busy': busy, 'idle': total - busy,
            'busy_share': busy / total, 'idle_share': 1.0 - busy / total}


def device_busy_share(trace_path, window=None, top=8):
    """Read a Chrome trace written by ``device_trace`` and return the
    device's busy and idle seconds and shares inside ``window`` (the name
    of a ``Trace.annotate`` span; default: from the first device operation
    to the last), with the ``top`` device operations by total time inside it
    as (name, seconds, count), under the names the profiler gives them
    (a kernel launched through ``ctypes`` appears under its C++ name).
    Device operations are the CUDA kernels, memory copies and memsets.
    Raises ``ValueError`` when the trace holds no device operation (a
    trace taken without a CUDA device) or lacks the window."""
    with open(trace_path) as fh:
        events = json.load(fh)['traceEvents']
    span = None
    if window is not None:
        named = [e for e in events if e.get('name') == window
                 and e.get('ph') == 'X'
                 and e.get('cat') in ('user_annotation', 'cpu_op')]
        if not named:
            raise ValueError(f'{trace_path}: no span named {window!r}')
        span = (named[0]['ts'], named[0]['ts'] + named[0]['dur'])
    device = [e for e in events if e.get('ph') == 'X'
              and e.get('cat') in DEVICE_CATEGORIES]
    if span is not None:
        device = [e for e in device
                  if e['ts'] < span[1] and e['ts'] + e['dur'] > span[0]]
    if not device:
        raise ValueError(f'{trace_path}: no device operation in the trace')
    share = busy_share([(e['ts'], e['ts'] + e['dur']) for e in device], span)
    totals = {}
    for e in device:
        seconds, count = totals.get(e['name'], (0.0, 0))
        totals[e['name']] = (seconds + e['dur'] * 1e-6, count + 1)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return {'window_s': share['window'] * 1e-6,
            'busy_s': share['busy'] * 1e-6, 'idle_s': share['idle'] * 1e-6,
            'busy_share': share['busy_share'],
            'idle_share': share['idle_share'],
            'n_device_operations': len(device),
            'top': [(name, s, c) for name, (s, c) in ranked]}
