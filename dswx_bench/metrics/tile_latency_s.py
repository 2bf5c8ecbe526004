"""Seconds a product: the window's seconds over the products completed in
it, one product run after another."""


def read(r):
    if not r['products']:
        return None
    return r['window_s'] / r['products']
