"""The ancillary cache's misses a product: the program's
``anc.<kind>.miss`` counters (``parallel/campaign.py::_AncillaryCache``,
every kind) over the window, over the products completed in it. None
where the record holds no program counters."""


def read(r):
    counters = r.get('program_counters')
    if counters is None or not r['products']:
        return None
    return sum(v for k, v in counters.items()
               if k.startswith('anc.') and k.endswith('.miss')) \
        / r['products']
