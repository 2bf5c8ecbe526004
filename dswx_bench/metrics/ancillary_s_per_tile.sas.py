"""Seconds a product preparing the ancillaries: the 'DEM warp', 'terrain
shadow' and 'landcover warps + LAND' stages of the breakdown
``generate_dswx_layers`` logs (``StageTimers``), the mean over the window's
products."""

STAGES = ('DEM warp', 'terrain shadow', 'landcover warps + LAND')


def read(r):
    timers = [t for t in (r.get('stage_timers') or []) if t]
    if not timers:
        return None
    return sum(t.get(s, 0.0) for t in timers for s in STAGES) / len(timers)
