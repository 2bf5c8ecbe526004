"""The warp kernel's share of its roofline, in %: the least time the card
could take for the three warps of each product in the window (the DEM's
cubic with its margin, CGLS's and WorldCover's nearest; the frozen counts
of ``counts/warp.py`` from the cell's own shapes and the source windows
the warp reads) over the trace's device time of the warp kernels."""

import re

from dswx_bench.counts.warp import warp_bound_s
from dswx_bench.reference.warp import grid_spacing, source_window

_KERNELS = re.compile(r'\bwarp_(nearest|kernel)_kernel\b')


def product_bound_s(grid, ancillaries, margin):
    """The least seconds of one product's three warps."""
    n, zone = grid['size'], grid['utm_zone']
    x0, dx, _, y0, _, dy = grid['geotransform']
    total = 0.0
    for key, algorithm, scale, m in (('dem', 'cubic', 1, margin),
                                     ('cgls', 'nearest', 1, 0),
                                     ('worldcover', 'nearest', 3, 0)):
        shape, src_gt, itemsize = ancillaries[key]
        px = dx / scale
        out = n * scale + 2 * m
        _, _, rows, cols = source_window(
            zone, src_gt, shape, x0 - m * px, y0 - m * dy / scale, px,
            dy / scale, out, out, 2 if algorithm == 'cubic' else 0)
        total += warp_bound_s(algorithm, rows, cols, itemsize, out, out,
                              4 if algorithm == 'cubic' else 1,
                              grid_spacing(px))
    return total


def read(r):
    t = r.get('trace')
    if not t or not r['attempted']:
        return None
    busy = sum(d for name, _, d in t['device'] if _KERNELS.search(name)) \
        * 1e-6
    if busy <= 0:
        return None
    bound = product_bound_s(r['grid'], r['ancillaries'],
                            r['processing']['dem_margin_px'])
    return 100.0 * bound * r['attempted'] / busy
