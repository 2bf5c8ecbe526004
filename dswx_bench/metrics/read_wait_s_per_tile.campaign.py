"""Seconds a product the campaign's main thread, which feeds the device,
spent blocked on a batch's reads: the program's ``campaign.wait_read``
spans (``parallel/campaign.py``) over the products completed in the
window. None where the record holds no program spans."""


def read(r):
    spans = r.get('program_spans')
    if not spans or not r['products']:
        return None
    return sum(s['end_ns'] - s['start_ns'] for s in spans
               if s['name'] == 'campaign.wait_read') * 1e-9 / r['products']
