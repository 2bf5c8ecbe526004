"""MiB copied from the host to the device a product: the program's
``h2d_bytes.<site>`` counters (``device.py::to_device``) over the window,
summed over the sites, over the products completed in it. None where the
record holds no program counters. Each cell's metric of this name reads
it (``h2d_mib_per_tile.<cell kind>.py``)."""


def read(r):
    counters = r.get('program_counters')
    if counters is None or not r['products']:
        return None
    return sum(v for k, v in counters.items()
               if k.startswith('h2d_bytes.')) / 2 ** 20 / r['products']
