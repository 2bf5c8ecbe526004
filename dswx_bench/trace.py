"""The traced window: ``torch.profiler`` over the window, and what is read
from its trace.

Device operations are the trace's CUDA kernels, memory copies and memsets
(``DEVICE_CATEGORIES``). Host spans are the trace's ``user_annotation``
events (the program's ``record_function`` spans, which the profiler keeps
for the thread that started it) and the harness's own spans around its
calls into the program on every thread (``annotate``, ``HostSpans``), placed
on the trace's time line by the window span's start.
``busy_share`` is a frozen copy of the program's interval arithmetic
(``runtime/profiling.py::busy_share``).
"""

import contextlib
import json
import os
import threading
import time

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
WINDOW_SPAN = 'dswx_bench.window'


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


def merged(intervals, window):
    """The union of ``intervals`` clipped to ``window``, as sorted disjoint
    (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        a, b = max(a, window[0]), min(b, window[1])
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(device, spans, window, top=10):
    """The ``top`` longest stretches of the window with no device
    operation: [[name, seconds], ...], each named by the innermost host
    span of each thread around its middle (``spans``: (name, ts, dur,
    thread)), joined by '+' where threads differ, or 'no host span'."""
    busy = merged([(ts, ts + dur) for _, ts, dur in device], window)
    gaps, cursor = [], window[0]
    for a, b in busy + [[window[1], window[1]]]:
        if a > cursor:
            gaps.append((cursor, a))
        cursor = max(cursor, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) / 2
        inner = {}
        for name, ts, dur, thread in spans:
            if ts <= mid <= ts + dur and (thread not in inner
                                          or dur < inner[thread][0]):
                inner[thread] = (dur, name)
        names = sorted({name for _, name in inner.values()})
        out.append(['+'.join(names) or 'no host span', (b - a) * 1e-6])
    return out


def top_operations(device, top=10):
    """The ``top`` device operations by their total seconds:
    [[name, seconds], ...]."""
    totals = {}
    for name, _, dur in device:
        totals[name] = totals.get(name, 0.0) + dur * 1e-6
    return [[n, s] for n, s in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:top]]


def read_trace(path):
    """(window (start, end), device [(name, ts, dur)], spans [(name, ts,
    dur, thread)]) of a Chrome trace, times in microseconds; the window is
    the ``WINDOW_SPAN`` annotation's."""
    with open(path) as fh:
        events = json.load(fh)['traceEvents']
    device, spans, window = [], [], None
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat')
        if cat in DEVICE_CATEGORIES:
            device.append((e['name'], float(e['ts']), float(e['dur'])))
        elif cat == 'user_annotation':
            span = (e['name'], float(e['ts']), float(e['dur']),
                    e.get('tid'))
            if e['name'] == WINDOW_SPAN:
                window = (span[1], span[1] + span[2])
            else:
                spans.append(span)
    if window is None:
        raise ValueError(f'{path}: no {WINDOW_SPAN} span')
    device = [d for d in device
              if d[1] < window[1] and d[1] + d[2] > window[0]]
    return window, device, spans


class HostSpans:
    """Spans the harness records around calls into the program, on every
    thread, by the host's clock; ``t0_ns`` is the window span's start by
    that clock, which places them on the trace's time line."""

    def __init__(self):
        self.items = []
        self.t0_ns = None
        self._lock = threading.Lock()

    def add(self, name, start_ns, end_ns):
        with self._lock:
            self.items.append((name, start_ns, end_ns,
                               threading.get_ident()))

    def on_trace(self, window):
        """The spans as (name, ts, dur, thread) in the trace's
        microseconds."""
        return [(name, window[0] + (a - self.t0_ns) * 1e-3, (b - a) * 1e-3,
                 f'host-{thread}') for name, a, b, thread in self.items]


@contextlib.contextmanager
def profiled(path, spans):
    """Profile the CPU and the CUDA device (where there is one) around
    the block, with the window span around it, and write the Chrome trace
    to ``path``; ``spans`` (a ``HostSpans``) gets the window's start."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            spans.t0_ns = time.perf_counter_ns()
            yield
            if cuda:
                torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(targets, spans):
    """Wrap each ``(owner, attribute, span name)`` of ``targets`` in a host
    span recorded in ``spans`` while the block runs."""
    saved = []

    def wrap(fn, name):
        def wrapped(*args, **kwargs):
            start = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                spans.add(name, start, time.perf_counter_ns())
        return wrapped

    try:
        for owner, attr, name in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(fn, name))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
