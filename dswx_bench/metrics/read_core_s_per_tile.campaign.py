"""The reader pool's core-seconds a product: the campaign's ``read_*``
stages (``parallel/campaign.py::STAGE_TIMES``, summed over the pool's
threads) over the products completed in the window."""


def read(r):
    stages = r.get('stage_seconds')
    if not stages or not r['products']:
        return None
    return sum(s for k, s in stages.items()
               if k.startswith('read_')) / r['products']
