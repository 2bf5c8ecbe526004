"""Products completed in the window, a GPU-hour: products x 3600 / (window
seconds x chips), over the window's whole passes."""


def read(r):
    if not r['window_s']:
        return None
    return r['products'] * 3600.0 / (r['window_s'] * r['chips'])
