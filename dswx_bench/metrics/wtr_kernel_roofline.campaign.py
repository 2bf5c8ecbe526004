"""The per-pixel kernel's share of its roofline, in %: the least time the
card could take for the function of the window's products (the frozen
counts of ``counts/wtr_kernel.py`` from the tile's shape) over the trace's
device time of ``wtr_pixel_kernel`` launches."""

from dswx_bench.counts.wtr_kernel import campaign_bound_s


def read(r):
    t = r.get('trace')
    if not t or not r['products']:
        return None
    busy = sum(d for name, _, d in t['device']
               if 'wtr_pixel_kernel' in name) * 1e-6
    if busy <= 0:
        return None
    n = r['grid']['size']
    return 100.0 * campaign_bound_s(r['products'], n * n) / busy
