"""Tracing and per-stage timing.

- ``TRACER`` (a ``Tracer``): the port's one tracer. ``TRACER.span(name)``
  marks a span of work on the calling thread: its name, start and end by
  ``time.perf_counter_ns()``, the thread's CPU time over it
  (``time.thread_time_ns()``), the thread, an id, its parent (the span
  open around it on the thread, or the one ``TRACER.carry`` brought to a
  pool's thread) and the tile or product it works on. Spans are kept
  only between ``TRACER.start()`` and ``TRACER.stop()`` (a capture), which
  returns them; with no capture a span costs one boolean test. On the
  thread that started a capture with ``anchors=True`` (one that runs
  ``torch.profiler``) each span also enters ``record_function``, so it is
  stamped on the profiler's clock too;
- ``COUNTERS`` (a ``Counters``): integers by name, always on: bytes
  copied between host and device by call site, cache hits and misses,
  kernel builds. A capture returns their change over it;
- ``StageTimers`` (copied from ``proteus_tpu/runtime/profiling.py:21-48``):
  named wall-clock stage timers of one product run, logged as a breakdown
  table at its end; ``StageTimes`` (``STAGE_TIMES``): the campaign's
  stage table, wall seconds and calls a stage summed over the pools'
  threads, switched on by ``PROTEUS_TPU_STAGE_TIMES=1``. Both time their
  stages as tracer spans;
- ``device_trace``: context manager around ``torch.profiler.profile`` (CPU
  and CUDA activities) and an anchored capture, which writes a Chrome
  trace (view with Perfetto or chrome://tracing) holding every span of
  the thread that opened it; counterpart of ``proteus_tpu/runtime/
  profiling.py:51-61``, which wraps ``jax.profiler.trace``;
- ``device_busy_share``: from a written trace, how long the device was
  busy and idle inside a window, and its top operations by total time.
  ``busy_share`` is the interval arithmetic under it.

This module imports nothing of ``torch`` or its profiler, and starts no
profiler, unless a trace directory is given or an anchored capture is
started, so a run without one pays nothing for it.
"""

import contextlib
import dataclasses
import functools
import itertools
import json
import logging
import os
import threading
import time

logger = logging.getLogger('dswx_hls')

# categories of the Chrome trace's events that occupy the device
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Counters:
    """Integers by name (thread-safe), always on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._values = {}

    def add(self, name, n=1):
        with self._lock:
            self._values[name] = self._values.get(name, 0) + n

    def snapshot(self):
        with self._lock:
            return dict(self._values)

    @staticmethod
    def delta(after, before):
        """The counters of ``after`` that moved since ``before``, by how
        much."""
        return {k: v - before.get(k, 0) for k, v in sorted(after.items())
                if v != before.get(k, 0)}


COUNTERS = Counters()


@dataclasses.dataclass(slots=True)
class Span:
    """One finished span. ``thread`` is the name of the thread it ran on
    (None for a wait in a pool's queue, which no thread spends). A span
    that also entered ``record_function`` has ``anchor``: the
    ``perf_counter_ns`` times just before and just after that enter, and
    before and after that exit, which bracket the profiler's stamps of
    its start and end."""

    name: str
    span_id: int
    parent: int | None
    thread: str | None
    item: object
    start_ns: int
    end_ns: int
    cpu_ns: int
    anchor: tuple | None = None

    def as_dict(self):
        d = {'name': self.name, 'id': self.span_id, 'parent': self.parent,
             'thread': self.thread, 'item': self.item,
             'start_ns': self.start_ns, 'end_ns': self.end_ns,
             'cpu_ns': self.cpu_ns}
        if self.anchor:
            d['anchor'] = list(self.anchor)
        return d


@dataclasses.dataclass
class Capture:
    """What ``Tracer.stop`` returns: the ``spans`` finished during the
    capture, the ``counters`` that moved, and the name of the ``thread``
    that started it (the one whose spans are anchored, if any)."""

    spans: list
    counters: dict
    thread: str

    def records(self):
        return [s.as_dict() for s in self.spans]


class _Open:
    """A span being recorded (what ``Tracer.span`` enters during a
    capture)."""

    __slots__ = ('tracer', 'name', 'item', 'parent', 'table', 'rf',
                 'span_id', 'stack', 't0', 'c0', 'anchor0')

    def __init__(self, tracer, name, item, table):
        self.tracer = tracer
        self.name = name
        self.item = item
        self.parent = None
        self.table = table
        self.rf = None

    def __enter__(self):
        tracer = self.tracer
        stack = self.stack = tracer._stack()
        if stack:
            self.parent, item = stack[-1]
            if self.item is None:
                self.item = item
        self.span_id = next(tracer._ids)
        stack.append((self.span_id, self.item))
        if tracer._anchor_ident == threading.get_ident():
            self.rf = tracer._record_function(self.name)
            a = time.perf_counter_ns()
            self.rf.__enter__()
            self.anchor0 = (a, time.perf_counter_ns())
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        c1 = time.thread_time_ns()
        anchor = None
        if self.rf is not None:
            a = time.perf_counter_ns()
            self.rf.__exit__(*exc)
            anchor = (*self.anchor0, a, time.perf_counter_ns())
        self.stack.pop()
        if self.table is not None:
            self.table.add(self.name, (t1 - self.t0) * 1e-9)
        spans = self.tracer._spans
        if spans is not None:
            spans.append(Span(self.name, self.span_id, self.parent,
                              threading.current_thread().name, self.item,
                              self.t0, t1, c1 - self.c0, anchor))
        return False


class _Timed:
    """A stage timed for its table alone (no capture running)."""

    __slots__ = ('table', 'name', 't0')

    def __init__(self, table, name):
        self.table = table
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.table.add(self.name, time.perf_counter() - self.t0)
        return False


_OFF = contextlib.nullcontext()


class Tracer:
    """Spans on every thread, kept between ``start`` and ``stop``."""

    def __init__(self):
        self.capturing = False
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spans = None
        self._anchor_ident = None
        self._record_function = None
        self._thread = None
        self._counters0 = None

    def span(self, name, item=None, table=None):
        """A context manager around one span named ``name``, whose parent
        is the span open around it on this thread; ``item`` (the tile or
        product) defaults to that span's. ``table`` (a stage table:
        ``add(name, seconds)``) gets the span's wall seconds whether or
        not a capture runs. Entering it gives the open span, or None with
        no capture."""
        if self.capturing:
            return _Open(self, name, item, table)
        if table is not None:
            return _Timed(table, name)
        return _OFF

    def _stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def carry(self, fn, item=None, queued=None):
        """``fn`` for another thread (a pool's), to run under the span open
        here now: its spans get that span as their parent and its item
        (or ``item``). With ``queued``, a span of that name records the
        wait from now until ``fn`` starts. With no capture, ``fn``."""
        if not self.capturing:
            return fn
        stack = self._stack()
        parent, top_item = stack[-1] if stack else (None, None)
        item = top_item if item is None else item
        submitted = time.perf_counter_ns()

        def carried(*args, **kwargs):
            spans = self._spans
            if queued and spans is not None:
                spans.append(Span(queued, next(self._ids), parent, None,
                                  item, submitted, time.perf_counter_ns(),
                                  0))
            stack = self._stack()
            stack.append((parent, item))
            try:
                return fn(*args, **kwargs)
            finally:
                stack.pop()
        return carried

    def traced(self, name):
        """Decorate a function to run as a span named ``name``."""
        def wrap(fn):
            @functools.wraps(fn)
            def run(*args, **kwargs):
                with self.span(name):
                    return fn(*args, **kwargs)
            return run
        return wrap

    def start(self, anchors=False):
        """Start keeping spans. With ``anchors`` (on a thread that runs
        ``torch.profiler``), this thread's spans also enter
        ``record_function``, and a span marks the capture's start and
        another its stop."""
        with self._lock:
            if self.capturing:
                raise RuntimeError('a capture is already running')
            if anchors:
                from torch.profiler import record_function
                self._record_function = record_function
                self._anchor_ident = threading.get_ident()
            self._thread = threading.current_thread().name
            self._spans = []
            self._counters0 = COUNTERS.snapshot()
            self.capturing = True
        if anchors:
            with self.span('capture.start'):
                pass

    def stop(self):
        """Stop keeping spans; returns the ``Capture``."""
        if self._anchor_ident == threading.get_ident():
            with self.span('capture.stop'):
                pass
        with self._lock:
            if not self.capturing:
                raise RuntimeError('no capture is running')
            self.capturing = False
            spans, self._spans = self._spans, None
            self._anchor_ident = self._record_function = None
            counters = Counters.delta(COUNTERS.snapshot(), self._counters0)
        return Capture(spans, counters, self._thread)


TRACER = Tracer()


class StageTimers:
    """The stages of one product run, in order, as (name, seconds)."""

    def __init__(self):
        self.stages = []  # (name, seconds), ordered

    def stage(self, name):
        return TRACER.span(name, table=self)

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


class StageTimes:
    """Cumulative wall-clock per pipeline stage (thread-safe).

    Enabled by PROTEUS_TPU_STAGE_TIMES=1; CampaignRunner.run() returns
    the table under stats['stage_seconds']. Stage seconds are summed
    across pool threads, so they measure CORE-seconds of occupancy (plus
    in-stage waiting, e.g. d2h transfer time inside 'd2h_*'), not
    wall-clock. A stage is a tracer span whether or not the table is on.
    """

    def __init__(self):
        self.enabled = os.environ.get('PROTEUS_TPU_STAGE_TIMES') == '1'
        self._lock = threading.Lock()
        self.totals = {}

    def stage(self, name):
        return TRACER.span(name, table=self if self.enabled else None)

    def add(self, name, seconds):
        with self._lock:
            cur = self.totals.setdefault(name, [0.0, 0])
            cur[0] += seconds
            cur[1] += 1

    def reset(self):
        with self._lock:
            self.totals = {}

    def table(self):
        return {k: {'seconds': round(v[0], 2), 'calls': v[1]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1][0])}


STAGE_TIMES = StageTimes()


class Trace:
    """What ``device_trace`` yields: ``path`` is the trace file once the
    context has closed (None when tracing is off)."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.path = None


@contextlib.contextmanager
def device_trace(trace_dir):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is
    one, the CUDA device into a new Chrome trace file under ``trace_dir``
    (a no-op when ``trace_dir`` is falsy), with the spans of the calling
    thread in it (an anchored capture, unless one already runs). Yields
    a ``Trace``."""
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
        own = not TRACER.capturing
        if own:
            TRACER.start(anchors=True)
        try:
            yield trace
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            if own:
                TRACER.stop()
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
    of a span in the trace; default: from the first device operation
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
