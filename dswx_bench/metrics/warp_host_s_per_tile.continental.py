"""The seconds a product the warps spend on the host: every ``warp.``
stage of the program (``geo/warp.py``: the window's read, the coordinate
lattice, the source's mask and copy, the re-decision of ambiguous
pixels; in ``parallel/campaign.py::STAGE_TIMES``, summed over the
threads that warp) over the products completed in the window. None
where the record holds no ``warp.`` stage (a program without the warps'
stages)."""


def read(r):
    stages = r.get('stage_seconds')
    if not stages or not r['products']:
        return None
    warp = [s for k, s in stages.items() if k.startswith('warp.')]
    if not warp:
        return None
    return sum(warp) / r['products']
