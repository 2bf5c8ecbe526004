"""Per-stage timing.

``StageTimers`` (copied from ``proteus_tpu/runtime/profiling.py:21-48``):
lightweight named wall-clock stage timers, logged as a breakdown table at
the end of a product run. The JAX package's ``device_trace`` and
``annotate`` wrap ``jax.profiler`` and have no counterpart here yet
(ROADMAP.md Queue 1 item 15).
"""

import contextlib
import logging
import time

logger = logging.getLogger('dswx_hls')


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
