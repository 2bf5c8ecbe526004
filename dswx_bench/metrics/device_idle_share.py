"""The share of the window, in %, in which no kernel, memory copy or memset
ran on the device, from the window's trace. Each cell's metric of this
name reads it (``device_idle_share.<cell kind>.py``)."""

from dswx_bench.trace import busy_share


def read(r):
    t = r.get('trace')
    if not t or not t['device']:
        return None
    share = busy_share([(ts, ts + d) for _, ts, d in t['device']],
                       t['window'])
    return 100.0 * share['idle_share']
