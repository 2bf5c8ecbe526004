"""The writer pool's thread CPU seconds a product: the program's
``write_*`` stage spans (the stages ``write_core_s_per_tile.campaign``
sums as wall seconds) over the products completed in the window. None
where the record holds no program spans."""


def read(r):
    spans = r.get('program_spans')
    if not spans or not r['products']:
        return None
    return sum(s['cpu_ns'] for s in spans
               if s['name'].startswith('write_')) * 1e-9 / r['products']
