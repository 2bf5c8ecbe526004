"""Seconds from the start of the run to the window: importing, making the
inputs, building what is not built yet, and the warm-up."""


def read(r):
    return r['setup_s']
