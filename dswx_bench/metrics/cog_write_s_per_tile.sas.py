"""Seconds a product writing the layers: the 'layer saves (COG encode)'
stage of the breakdown ``generate_dswx_layers`` logs (``StageTimers``), the
mean over the window's products."""


def read(r):
    timers = [t for t in (r.get('stage_timers') or []) if t]
    if not timers:
        return None
    return sum(t.get('layer saves (COG encode)', 0.0)
               for t in timers) / len(timers)
