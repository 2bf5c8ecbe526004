"""The program's entries that a configuration's window drives, one module
a kind, named by the configuration's ``entry`` key."""

import importlib


def load(name):
    """The ``Entry`` class of ``entries/<name>.py``."""
    return importlib.import_module(f'dswx_bench.entries.{name}').Entry
