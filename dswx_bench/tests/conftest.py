"""Small sizes of the benchmark's cells for the CPU tests, and the marker
of the tests that need a card (they decide inside the test whether one is
there)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; skips without one')


def tiny(workload, size=64, acquisitions=None):
    """(config, mix) of ``workload`` at a small tile, a 0.02 deg margin
    and coarser ancillaries (DEM 3", WorldCover 1"); the science settings
    and the mix as the cell's files state them."""
    from dswx_bench import registry
    cell = registry.cell(registry.benchmark(), workload)
    config = registry.config(cell['config'])
    mix = registry.traffic(cell['traffic'])
    config['tile']['size'] = size
    anc = config['ancillaries']
    anc['margin_deg'] = 0.02
    anc['dem']['resolution_deg'] = 1 / 1200
    anc['worldcover']['resolution_deg'] = 1 / 3600
    if acquisitions is not None:
        mix['acquisitions'] = acquisitions
    return config, mix


@pytest.fixture
def work(tmp_path):
    return str(tmp_path / 'work')
