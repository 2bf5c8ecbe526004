"""``BENCHMARK.json`` and a run's last line keep to the benchmark's
contract: keys, names, units, characters and limits."""

import json
import os
import re

import pytest

from conftest import ROOT, tiny
from dswx_bench import registry, run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
WIDTH = re.compile(r'(_dim|_rank)$|hidden|intermediate|latent|state|'
                   r'projection|head|expansion|experts_per')


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and '\n' not in text and '\t' not in text


def test_benchmark_json_keeps_to_the_contract():
    path = os.path.join(ROOT, 'BENCHMARK.json')
    assert os.path.getsize(path) <= 64 * 1024
    b = registry.benchmark()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs',
                      'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= len(b['paths']) <= 16
    for p in b['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(b['command']) <= 32
    assert all(_line(w) for w in b['command'])
    assert isinstance(b['run_seconds'], int) and 1 <= b['run_seconds'] <= 51

    names = set()
    for c in b['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['source'])
        assert _line(c['why']) and len(c['reduced']) <= 16
        assert any(c['file'].startswith(p + '/') for p in b['paths'])
        assert not any(WIDTH.search(k) for k in c['reduced'])
        names.add(c['name'])
    assert len(names) == len(b['configs'])

    pairs, cells = set(), set()
    for w in b['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        for k in ('name', 'config', 'traffic'):
            assert NAME.match(w[k])
        assert w['config'] in names and w['chips'] in (1, 4)
        assert _line(w['why'])
        pairs.add((w['config'], w['traffic']))
        cells.add(w['name'])
    assert len(pairs) == len(cells) == len(b['workloads'])
    assert sum(w['chips'] == 4 for w in b['workloads']) <= max(
        1, len(b['workloads']) // 4)
    assert {c['name'] for c in b['configs']} == {w['config']
                                                for w in b['workloads']}

    metrics = set()
    assert any(m['name'] == 'setup_s' and m['bound'] <= 0.25
               for m in b['end_to_end'])
    for m in b['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    layers = {}
    for m in b['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert _line(m['layer'])
        assert m['moves'] in {e['name'] for e in b['end_to_end']}
        for cell in m['workloads']:
            e2e = [e for e in b['end_to_end'] if e['name'] == m['moves']][0]
            assert cell in e2e.get('workloads', cells)
        if m['name'].split('.')[0].endswith('_roofline'):
            assert m['unit'] == '%'
        layers.setdefault(m['layer'], m['layer'])
    for m in b['end_to_end'] + b['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert set(m.get('workloads', cells)) <= cells
        metrics.add(m['name'])
    assert len(metrics) == len(b['end_to_end']) + len(b['per_layer'])
    for cell in cells:
        e2e = registry.metrics_of(b, cell, False)
        assert any(m['name'] == 'setup_s' for m in e2e) and len(e2e) >= 2
        assert registry.metrics_of(b, cell, True)


def _schema(result, traced):
    assert list(result)[-1] == 'checks'
    assert {'correct', 'attempted', 'failed', 'metrics', 'device'} \
        <= set(result)
    assert isinstance(result['correct'], bool)
    for name, m in result['metrics'].items():
        assert NAME.match(name) and UNIT.match(m['unit'])
        assert isinstance(m['value'], (int, float))
    d = result['device']
    assert {'platform', 'kind', 'count', 'memory_peak_bytes'} <= set(d)
    if traced:
        assert {'busy_s', 'window_s'} <= set(d)
        for key in ('device_ops', 'idle_gaps'):
            assert len(result['breakdown'][key]) <= 10
    for name, c in result['checks'].items():
        assert set(c) == {'value', 'limit'}
    json.dumps(result)


@pytest.mark.parametrize('traced', [False, True])
def test_last_line_schema(work, traced):
    config, mix = tiny('campaign_timeseries', acquisitions=2)
    result, lines = run.run_cell('campaign_timeseries', 2 ** 33 + 5, 0.5,
                                 traced, 'cpu', config=config, mix=mix,
                                 work=work)
    _schema(result, traced)
    assert result['correct'] and result['attempted'] >= 2
    if traced:
        assert {'ancillary_cache_misses'} <= set(lines[0])
        assert set(result['metrics']) == {'read_core_s_per_tile.campaign',
                                          'write_core_s_per_tile.campaign'}
    else:
        assert set(result['metrics']) == {'tiles_per_gpu_hour', 'setup_s'}
    assert any('bytes_written' in line for line in lines)


def test_no_result_without_the_cards_or_the_program(tmp_path):
    """A run exits with another code than 0 and prints no result where
    the card is missing, and where the checkout holds only the benchmark
    (the program is not importable)."""
    import shutil
    import subprocess
    import sys
    shutil.copytree(os.path.join(ROOT, 'dswx_bench'),
                    tmp_path / 'dswx_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    argv = [sys.executable, '-m', 'dswx_bench', '--workload',
            'sas_single_tile', '--seed', str(2 ** 40 + 1), '--seconds', '1',
            '--trace', '0']
    out = subprocess.run(argv, cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and '"correct"' not in out.stdout
    code = ('import sys; from conftest import tiny; '
            'from dswx_bench import run; c, m = tiny("sas_single_tile"); '
            f'run.run_cell("sas_single_tile", 1, 0.1, False, "cpu", '
            f'config=c, mix=m, work={str(tmp_path / "w")!r})')
    env = dict(os.environ, PYTHONPATH=str(tmp_path / 'dswx_bench' / 'tests'))
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "No module named 'proteus_tpu_torch'" in out.stderr
    assert not (tmp_path / 'w' / 'run').exists()
