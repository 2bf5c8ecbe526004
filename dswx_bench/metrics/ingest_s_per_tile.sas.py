"""Seconds a product in ingest: the 'ingest (HLS bands)' stage of the
breakdown ``generate_dswx_layers`` logs (``StageTimers``), the mean over
the window's products."""


def read(r):
    timers = [t for t in (r.get('stage_timers') or []) if t]
    if not timers:
        return None
    return sum(t.get('ingest (HLS bands)', 0.0) for t in timers) / len(timers)
