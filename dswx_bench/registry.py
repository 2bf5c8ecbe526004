"""Everything of a cell, found by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the deployment (tile grid, ancillaries,
  science and entry settings, its source, ``reduced`` and ``assumed``);
- ``traffic/<traffic>.json``: the mix, parameters of the one generator
  (``generate.py``) and of the window's loop;
- ``metrics/<metric>.py``: one reader a metric, ``read(record)``, which
  returns the metric's value or None where the run has nothing to read.

A new configuration, mix or metric is a new file here and a new entry in
``BENCHMARK.json``; no file that exists changes.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root=ROOT):
    with open(os.path.join(root, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def _json(kind, name):
    path = os.path.join(HERE, kind, f'{name}.json')
    with open(path) as fh:
        return json.load(fh)


def config(name):
    return _json('configs', name)


def traffic(name):
    return _json('traffic', name)


def cell(bench, workload):
    """The ``workloads`` entry named ``workload``; KeyError if none."""
    for w in bench['workloads']:
        if w['name'] == workload:
            return w
    raise KeyError(f'no workload named {workload!r} in BENCHMARK.json')


def metrics_of(bench, workload, trace):
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones without a trace, the per-layer ones with it; a metric with a
    ``workloads`` key only in the cells it names."""
    group = bench['per_layer'] if trace else bench['end_to_end']
    return [m for m in group
            if workload in m.get('workloads', (workload,))]


def reader(name):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(HERE, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'dswx_bench.metrics.{name}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
