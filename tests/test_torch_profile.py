"""The port's null kernel, tracing and profile tools on the CPU.

- ``ops/null_kernel.py``: the plain twin against the Pallas TPU kernel
  ``tools/kernel_profile.py::_null_kernel`` run in interpret mode (the tool
  passes no ``interpret=``, so the test patches
  ``jax.experimental.pallas.pallas_call`` with ``interpret=True`` for the
  call; the tool itself is not edited), on the same seeded numpy inputs,
  tolerance 0; the wrapper's checks.
- ``runtime/profiling.py``: ``busy_share`` on synthetic intervals,
  ``device_trace`` off (no profiler import) and on (a trace file holding
  the tracer's spans), and ``device_busy_share`` on a synthetic Chrome
  trace (the tracer itself: ``tests/test_torch_tracing.py``).
- ``tools/kernel_profile.py`` and ``tools/bench.py`` on ``--device cpu`` at
  small sizes: the JAX tools' variant names, byte counts and JSON keys.
"""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from proteus_tpu_torch.ops import null_kernel
from proteus_tpu_torch.ops.null_kernel import null_fold, null_fold_plain
from proteus_tpu_torch.runtime import profiling
from proteus_tpu_torch.tools import bench as tbench
from proteus_tpu_torch.tools import kernel_profile as tprofile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def jax_tool():
    """``tools/kernel_profile.py`` of the JAX package, loaded from its
    path (``tools/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        'jax_kernel_profile', os.path.join(REPO, 'tools',
                                           'kernel_profile.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _planes(rng, shape, kinds):
    out = []
    for kind in kinds:
        if kind == 'u8':
            out.append(rng.integers(0, 256, shape).astype(np.uint8))
        elif kind == 'i16':
            out.append(rng.integers(-32768, 32768, shape).astype(np.int16))
        else:  # fractions of both signs: the cast truncates toward zero
            out.append(rng.uniform(-30000, 30000, shape).astype(np.float32))
    return out


NULL_CASES = {
    'one-u8': ('u8',),
    'one-i16': ('i16',),
    'one-f32': ('f32',),
    'three-mixed': ('i16', 'u8', 'f32'),
    'eight-int16-footprint': ('i16',) * 6 + ('u8', 'u8'),
    'eight-f32-footprint': ('f32',) * 6 + ('u8', 'u8'),
    'eight-mixed': ('f32', 'i16', 'u8', 'f32', 'i16', 'u8', 'i16', 'f32'),
}


@pytest.mark.parametrize('name', sorted(NULL_CASES))
def test_null_fold_plain_matches_the_pallas_kernel(jax_tool, monkeypatch,
                                                   name):
    """40 rows in blocks of 16: the last block is ragged."""
    kinds = NULL_CASES[name]
    h, w, block_rows = 40, 128, 16
    rng = np.random.default_rng(len(kinds) * 7 + len(name))
    planes = _planes(rng, (h, w), kinds)
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))
    want = np.asarray(jax_tool._null_kernel(h, w, block_rows,
                                            len(kinds))(*planes))
    got = null_fold(*[torch.from_numpy(p) for p in planes])
    assert got.dtype == torch.uint8 and tuple(got.shape) == (h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the numpy statement of the kernel body (:84-87)
    acc = np.zeros((h, w), np.int32)
    for p in planes:
        acc ^= p.astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), acc.astype(np.uint8))


def test_null_fold_on_the_cpu_counts_no_launch():
    before = dict(null_kernel.LAUNCHES)
    a = torch.arange(24, dtype=torch.int16).reshape(4, 6)
    out = null_fold(a, a.to(torch.bool))
    assert torch.equal(out, null_fold_plain(a, a != 0))
    assert null_kernel.LAUNCHES == before


@pytest.mark.parametrize('bad,match', [
    (lambda a: [], 'takes 1 to'),
    (lambda a: [a] * 9, 'takes 1 to'),
    (lambda a: [a, a[:2]], 'shape'),
    (lambda a: [a.to(torch.int32)], 'dtype'),
    (lambda a: [a.t()], 'contiguous'),
    (lambda a: [a[:0]], 'empty'),
])
def test_null_fold_refuses(bad, match):
    a = torch.zeros((4, 6), dtype=torch.int16)
    with pytest.raises(ValueError, match=match):
        null_fold(*bad(a))


# ---- runtime/profiling.py ---------------------------------------------------

@pytest.mark.parametrize('intervals,window,busy,total', [
    ([(0, 1), (2, 3)], None, 2.0, 3.0),                 # disjoint
    ([(0, 2), (1, 3)], None, 3.0, 3.0),                 # overlapping
    ([(0, 4), (1, 2), (3, 5)], None, 5.0, 5.0),         # nested + overlap
    ([(2, 3), (0, 1)], (0, 10), 2.0, 10.0),             # unsorted, window
    ([(-5, 1), (9, 20)], (0, 10), 2.0, 10.0),           # clipped to it
    ([(20, 30)], (0, 10), 0.0, 10.0),                   # outside it
    ([], (0, 4), 0.0, 4.0),                             # idle throughout
    ([(1, 1), (3, 2)], (0, 4), 0.0, 4.0),               # empty intervals
])
def test_busy_share(intervals, window, busy, total):
    got = profiling.busy_share(intervals, window)
    assert got['busy'] == busy and got['window'] == total
    assert got['idle'] == total - busy
    assert got['busy_share'] == busy / total
    assert got['idle_share'] == 1.0 - busy / total


def test_busy_share_needs_a_window():
    with pytest.raises(ValueError):
        profiling.busy_share([])
    with pytest.raises(ValueError):
        profiling.busy_share([(0, 1)], (3, 3))


def test_device_busy_share_reads_a_chrome_trace(tmp_path):
    events = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'stage', 'ts': 100.0,
         'dur': 100.0},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::add', 'ts': 100, 'dur': 5},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k<a>(int)', 'ts': 110.0,
         'dur': 20.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k<a>(int)', 'ts': 120.0,
         'dur': 20.0},                                   # overlaps the first
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'ts': 150.0,
         'dur': 10.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'late', 'ts': 300.0,
         'dur': 50.0},                                   # after the stage
        {'ph': 'i', 'cat': 'kernel', 'name': 'instant', 'ts': 130.0},
    ]
    path = tmp_path / 'trace.json'
    path.write_text(json.dumps({'traceEvents': events}))
    got = profiling.device_busy_share(str(path), window='stage')
    assert got['n_device_operations'] == 3
    assert got['window_s'] == pytest.approx(100e-6)
    assert got['busy_s'] == pytest.approx(40e-6)
    assert got['idle_share'] == pytest.approx(0.6)
    assert got['top'][0] == ('k<a>(int)', pytest.approx(40e-6), 2)
    whole = profiling.device_busy_share(str(path))
    assert whole['n_device_operations'] == 4
    assert whole['window_s'] == pytest.approx(240e-6)
    assert whole['busy_s'] == pytest.approx(90e-6)
    with pytest.raises(ValueError, match='no span'):
        profiling.device_busy_share(str(path), window='missing')
    path.write_text(json.dumps({'traceEvents': events[:2]}))
    with pytest.raises(ValueError, match='no device operation'):
        profiling.device_busy_share(str(path))


_OFF_SCRIPT = r'''
import sys
from proteus_tpu_torch.runtime.profiling import TRACER, device_trace
with device_trace(None) as t, TRACER.span('x'):
    pass
with device_trace('') as t:
    pass
assert t.path is None and not t.enabled
bad = [m for m in sys.modules if m.startswith('torch.profiler')
       or m in ('jax', 'proteus_tpu')]
assert not bad, bad
print('OFF-OK')
'''


def test_device_trace_off_imports_no_profiler():
    """In a fresh process: the module does not import torch at all, and
    with no trace directory nothing of torch.profiler is loaded."""
    proc = subprocess.run([sys.executable, '-c', _OFF_SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'OFF-OK' in proc.stdout


def test_device_trace_off_starts_no_profiler(monkeypatch):
    import torch.profiler

    def refuse(*args, **kwargs):
        raise AssertionError('a profiler was started')
    monkeypatch.setattr(torch.profiler, 'profile', refuse)
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    with profiling.device_trace(None) as trace:
        with profiling.TRACER.span('stage'):
            value = float(torch.ones(8).sum())
    assert value == 8.0 and trace.path is None


def test_device_trace_writes_a_trace(tmp_path):
    trace_dir = tmp_path / 'traces'
    with profiling.device_trace(str(trace_dir)) as trace:
        with profiling.TRACER.span('stage one'):
            torch.ones(64).sum()
        with profiling.TRACER.span('stage two'):
            torch.ones(64).sum()
    assert trace.enabled and os.path.isfile(trace.path)
    assert os.path.dirname(trace.path) == str(trace_dir)
    with open(trace.path) as fh:
        names = {e.get('name') for e in json.load(fh)['traceEvents']}
    assert {'stage one', 'stage two'} <= names
    # a trace of the CPU alone holds no device operation
    with pytest.raises(ValueError, match='no device operation'):
        profiling.device_busy_share(trace.path, window='stage one')


# ---- tools/kernel_profile.py ------------------------------------------------

JAX_VARIANTS = ('floor_int16_inputs', 'floor_f32_inputs', 'int_full',
                'int_minimal_packed', 'int_full_cover', 'scaled_full',
                'scaled_minimal_packed')


@pytest.fixture(scope='module')
def profile_run(tmp_path_factory):
    out = tmp_path_factory.mktemp('profile') / 'profile.json'
    before = dict(null_kernel.LAUNCHES)
    rc = tprofile.main(['--device', 'cpu', '--size', '96', '--iters', '2',
                        '--passes', '2', '--out', str(out)])
    assert rc == 0
    assert null_kernel.LAUNCHES == before  # the CPU launches no kernel
    with open(out) as fh:
        return json.load(fh)


def test_kernel_profile_has_the_jax_tools_variants(profile_run, jax_tool):
    """Every variant the JAX tool records but its block_rows sweep, in its
    order, then the plain chain in the place of xla_chain."""
    with open(jax_tool.__file__) as fh:
        source = fh.read()
    for name in JAX_VARIANTS + ('xla_chain',):
        assert f"'{name}'" in source, name
    assert tuple(profile_run['variants']) == JAX_VARIANTS + ('plain_chain',)
    assert not any('block' in name for name in profile_run['variants'])
    assert profile_run['device'] == 'cpu'
    assert profile_run['timer'] == 'host clock'


@pytest.mark.parametrize('name,in_b,out_b', [
    ('floor_int16_inputs', 14, 1), ('floor_f32_inputs', 26, 1),
    ('int_full', 14, 9), ('int_minimal_packed', 14, 2),
    ('int_full_cover', 14, 9), ('scaled_full', 26, 9),
    ('scaled_minimal_packed', 26, 2), ('plain_chain', 14, 9)])
def test_kernel_profile_byte_counts(profile_run, name, in_b, out_b):
    """tools/kernel_profile.py:136-137, 154-178, 215: (6 x 2 + 1 + 1) or
    (6 x 4 + 1 + 1) B/px in; 1, 2 or 9 B/px out."""
    v = profile_run['variants'][name]
    px = 96 * 96
    assert v['hbm_in_mb'] == round(in_b * px / 1e6, 1)
    assert v['hbm_out_mb'] == round(out_b * px / 1e6, 1)
    assert v['s_per_tile'] > 0 and len(v['pass_s']) == 2
    assert v['effective_gbps'] == pytest.approx(
        (in_b + out_b) * px / 1e9 / v['s_per_tile'])


def test_kernel_profile_attribution(profile_run):
    v = profile_run['variants']
    att = profile_run['attribution']
    want = 1 - (v['floor_int16_inputs']['s_per_tile']
                / v['int_minimal_packed']['s_per_tile'])
    assert att['int_minimal_compute_share'] == pytest.approx(want)
    assert set(att['compute_share']) == set(tprofile.FLOOR_OF)
    assert att['compute_share']['scaled_full'] == pytest.approx(
        1 - v['floor_f32_inputs']['s_per_tile']
        / v['scaled_full']['s_per_tile'])
    assert att['conclusion'] in ('compute-bound', 'traffic/overhead-bound')


def test_kernel_profile_inputs_are_the_jax_tools(jax_tool):
    """The same seeded inputs as tools/kernel_profile.py:120-127."""
    size = 24
    rng = np.random.default_rng(0)
    bands = [np.clip(rng.integers(-2000, 15000, (size, size)), 1,
                     None).astype(np.int16) for _ in range(6)]
    fmask = rng.integers(0, 256, (size, size)).astype(np.uint8)
    invalid = (rng.random((size, size)) < 0.02).astype(np.uint8)
    dev_int, dev_float = tprofile.make_inputs(size, torch.device('cpu'))
    for got, want in zip(dev_int, bands + [fmask, invalid]):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(dev_float[:6], bands):
        np.testing.assert_array_equal(
            got.numpy(), np.float32(0.0001) * want.astype(np.float32))


def test_kernel_profile_fails_when_a_variant_fails(tmp_path, monkeypatch):
    """The JAX tool records a failing variant and goes on; the twin ends
    the run (a non-zero exit from the command line) and writes nothing."""
    def broken(*inputs):
        raise RuntimeError('null kernel launch failed: CUDA error 98')
    monkeypatch.setattr(tprofile, 'null_fold', broken)
    out = tmp_path / 'profile.json'
    with pytest.raises(RuntimeError, match='launch failed'):
        tprofile.main(['--device', 'cpu', '--size', '32', '--iters', '1',
                       '--passes', '1', '--out', str(out)])
    assert not out.exists()


def test_kernel_profile_needs_its_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='cuda'):
        tprofile.main(['--size', '32', '--out', str(tmp_path / 'p.json')])


def test_kernel_profile_trace(tmp_path):
    out = tmp_path / 'profile.json'
    assert tprofile.main(['--device', 'cpu', '--size', '32', '--iters', '1',
                          '--passes', '1', '--out', str(out), '--trace-dir',
                          str(tmp_path / 'trace')]) == 0
    with open(out) as fh:
        got = json.load(fh)
    assert os.path.isfile(got['trace'])
    assert 'trace_busy' not in got  # no device operation on the CPU


_TOOLS_SCRIPT = r'''
import sys
from proteus_tpu_torch.tools import bench, bench_e2e, kernel_profile
assert kernel_profile.main(['--device', 'cpu', '--size', '32', '--iters',
                            '1', '--passes', '1', '--out', sys.argv[1]]) == 0
assert bench.main(['--device', 'cpu', '--size', '32', '--iters', '1',
                   '--passes', '1']) == 0
assert bench_e2e.main(['--device', 'cpu', '--size', '48', '--tiles', '1',
                       '--runs', '1', '--no-ancillaries', '--root',
                       sys.argv[2]]) == 0
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'proteus_tpu'))
assert not bad, bad
print('TOOLS-OK')
'''


def test_tools_run_with_neither_jax_nor_proteus_tpu(tmp_path):
    """The three tools through their ``main`` in a fresh process on the
    CPU: each prints its JSON line, and no module of jax or proteus_tpu
    is loaded afterwards."""
    proc = subprocess.run(
        [sys.executable, '-c', _TOOLS_SCRIPT, str(tmp_path / 'p.json'),
         str(tmp_path / 'e2e')], cwd=REPO, capture_output=True, text=True,
        timeout=600, env={**os.environ, 'PROTEUS_TPU_TORCH_DEVICE': 'cpu'})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert 'TOOLS-OK' in proc.stdout
    records = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith('{')]
    assert [sorted(r)[0] for r in records] == [
        'artifact', 'baseline_s_per_tile', 'device']
    assert records[2]['metric'] == 'e2e_campaign_tiles_per_min_48x48'
    assert 'vs_baseline' not in records[2] and 'vs_baseline' in records[1]


# ---- tools/bench.py ---------------------------------------------------------

def test_bench_loads_the_checkouts_oracle_by_path():
    """The NumPy baseline is tests/oracle.py of this checkout, loaded by
    its path: ``sys.path`` and ``sys.modules`` stay as they were."""
    path_before, had_oracle = list(sys.path), 'oracle' in sys.modules
    oracle = tbench._oracle()
    assert os.path.samefile(oracle.__file__,
                            os.path.join(REPO, 'tests', 'oracle.py'))
    assert callable(oracle.full_chain)
    assert sys.path == path_before
    assert ('oracle' in sys.modules) == had_oracle


@pytest.mark.parametrize('extra,keys', [
    ([], set()), (['--float'], {'scaled_float_inputs'})])
def test_bench_prints_one_json_line(capsys, extra, keys):
    """The root bench.py's keys (bench.py:137-148)."""
    assert tbench.main(['--device', 'cpu', '--size', '48', '--iters', '1',
                        '--passes', '2', '--tiles-per-dispatch', '2']
                       + extra) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert {'metric', 'value', 'unit', 'vs_baseline', 'path',
            'tiles_per_dispatch', 'n_passes', 'pass_s_per_tile'} | keys \
        <= set(record)
    assert record['metric'] == 'full_chain_tiles_per_min_48x48'
    assert record['unit'] == 'tiles/min' and record['path'] == 'plain'
    assert record['tiles_per_dispatch'] == 2 and record['n_passes'] == 2
    assert len(record['pass_s_per_tile']) == 2 and record['value'] > 0
