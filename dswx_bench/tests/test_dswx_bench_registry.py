"""The harness finds every configuration, mix and metric by its name, and
a new metric is a new file and a new entry alone."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT
from dswx_bench import registry


def test_every_cell_finds_its_files():
    bench = registry.benchmark()
    for w in bench['workloads']:
        config = registry.config(w['config'])
        mix = registry.traffic(w['traffic'])
        assert config['name'] == w['config']
        assert mix['name'] == w['traffic']
        entry = os.path.join(registry.HERE, 'entries',
                             f'{config["entry"]}.py')
        assert os.path.isfile(entry)
    for c in bench['configs']:
        assert os.path.isfile(os.path.join(ROOT, c['file']))
        assert registry.config(c['name'])['reduced'] == c['reduced']


def test_every_metric_has_a_reader():
    bench = registry.benchmark()
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(registry.reader(m['name'])), m['name']


def test_metrics_of_a_cell():
    bench = registry.benchmark()
    e2e = {m['name'] for m in registry.metrics_of(
        bench, 'campaign_timeseries', False)}
    assert e2e == {'tiles_per_gpu_hour', 'setup_s'}
    e2e = {m['name'] for m in registry.metrics_of(
        bench, 'sas_single_tile', False)}
    assert e2e == {'tile_latency_s', 'peak_device_gib', 'setup_s'}
    layer = {m['name'] for m in registry.metrics_of(
        bench, 'sas_single_tile', True)}
    assert layer == {'ingest_s_per_tile.sas', 'ancillary_s_per_tile.sas',
                     'cog_write_s_per_tile.sas', 'warp_kernel_roofline.sas',
                     'device_idle_share.sas'}


def test_unknown_workload_raises():
    try:
        registry.cell(registry.benchmark(), 'no_such_cell')
    except KeyError:
        return
    raise AssertionError('an unknown workload was found')


def test_a_new_metric_is_a_new_file(tmp_path):
    """A copy of the benchmark with one more metric file and entry, and no
    other change, reports the metric."""
    shutil.copytree(os.path.join(ROOT, 'dswx_bench'),
                    tmp_path / 'dswx_bench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    bench = registry.benchmark()
    bench['per_layer'].append({
        'name': 'products_in_window.campaign', 'unit': 'tiles',
        'better': 'higher', 'source': 'program_counter',
        'layer': 'reader pool', 'moves': 'tiles_per_gpu_hour',
        'workloads': ['campaign_timeseries']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    (tmp_path / 'dswx_bench' / 'metrics'
     / 'products_in_window.campaign.py').write_text(
        'def read(r):\n    return r["products"]\n')
    code = ('from dswx_bench import registry\n'
            'b = registry.benchmark()\n'
            'names = [m["name"] for m in registry.metrics_of('
            'b, "campaign_timeseries", True)]\n'
            'print(names, registry.reader(names[-1])({"products": 7}))\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "'products_in_window.campaign'] 7" in out.stdout
