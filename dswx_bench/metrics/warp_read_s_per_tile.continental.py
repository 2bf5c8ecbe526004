"""The seconds a product the warps spend reading their source windows:
the program's ``warp.read`` stage (``geo/warp.py``: the window worked out
and read, in ``parallel/campaign.py::STAGE_TIMES``, summed over the
threads that warp) over the products completed in the window. None where
the record holds no ``warp.`` stage (a program without the warps'
stages)."""


def read(r):
    stages = r.get('stage_seconds')
    if not stages or not r['products'] \
            or not any(k.startswith('warp.') for k in stages):
        return None
    return stages.get('warp.read', 0.0) / r['products']
