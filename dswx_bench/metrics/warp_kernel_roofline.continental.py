"""The warp kernel's share of its roofline in forward production, in %:
the least time the card could take for the three warps of each product
attempted in the window (the DEM's cubic with its margin, CGLS's and
WorldCover's nearest; ``product_bound_s`` of
``warp_kernel_roofline.sas.py``, from the frozen counts of
``counts/warp.py`` and the source windows of ``reference/warp.py``) over
the trace's device time of the warp kernels. Every tile of the cell is
on a grid of its own, so every product pays its three warps.

The record holds the first grid alone, and the bound is worked out on
it for every product. The other grids lie whole 30 m pixels away in the
same UTM zone, so their outputs have the same shapes; their source
windows differ from the first's only by the cosine of their latitude,
a few percent over the 4 degrees the grids span."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    'dswx_bench.metrics.warp_kernel_roofline.sas',
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 'warp_kernel_roofline.sas.py'))
_sas = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_sas)


def read(r):
    t = r.get('trace')
    if not t or not r['attempted']:
        return None
    busy = sum(d for name, _, d in t['device']
               if _sas._KERNELS.search(name)) * 1e-6
    if busy <= 0:
        return None
    bound = _sas.product_bound_s(r['grid'], r['ancillaries'],
                                 r['processing']['dem_margin_px'])
    return 100.0 * bound * r['attempted'] / busy
