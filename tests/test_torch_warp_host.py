"""The device warp's CUDA kernels on the CPU: ``ops/csrc/warp_kernel.cuh``
compiled with g++ behind the ``cuda_runtime.h`` stand-in of
``tests/warp_host/`` (a block runs as one thread, the ``_rn`` intrinsics
are the IEEE operations, ``-ffp-contract=off``), bound and fed by
``ops/warp_kernel.py`` as on the card, and held against
``geo/warp.py::device_resample_plain`` bit for bit but NaN payloads in
every template instantiation: nearest with elements of 1, 2, 4 and 8
bytes, bilinear and cubic in the fast, unmasked-wrap and masked modes,
each with 32- and 64-bit indices (the 64-bit instantiations through an
entry of their own: the dispatch takes them only at 2^31 elements); then
sources of +-0, subnormals, +-inf, NaN and +-3e38, and lattices whose
differences are about 1e-30 and 1e31, which take the TwoProduct's Dekker
path. ``two_prod`` itself is held
against ``core/eft.py::two_prod`` (Dekker's) on operands aimed at its
guard's edges. The compiled code and the plain twin run in a process of
their own that has not imported jax, with the thread's flush-to-zero and
denormals-are-zero bits checked clear: subnormals are among the cases.
"""

import ctypes
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(REPO, 'tests', 'warp_host')
CSRC = os.path.join(REPO, 'proteus_tpu_torch', 'ops', 'csrc')

# the source window, the output grid, the lattice spacing
H, W = 37, 45
OUT_H, OUT_W = 41, 53
SPACING = 8

NEAREST_DTYPES = (np.uint8, np.int16, np.float32, np.float64)
# (wraps, with a validity mask)
MODES = {'fast': (False, False), 'unmasked-wrap': (True, False),
         'masked': (False, True), 'masked-wrap': (True, True)}


def _case(algorithm, dtype, mode, index64, lattice='smooth',
          source='normal'):
    wraps, masked = MODES[mode]
    name = (f'{algorithm}-{np.dtype(dtype).name}-{mode}-'
            f'int{64 if index64 else 32}')
    if lattice != 'smooth' or source != 'normal':
        name += f'-{lattice}-lattice-{source}-source'
    return name, dict(algorithm=algorithm, dtype=np.dtype(dtype).name,
                      wraps=wraps, masked=masked, index64=index64,
                      lattice=lattice, source=source)


CASES = dict(
    # every instantiation: warp_nearest_kernel<T, I>, warp_kernel_kernel<
    # taps, mode, I>
    [_case('nearest', d, m, i64) for d in NEAREST_DTYPES
     for m in ('fast', 'masked-wrap') for i64 in (False, True)]
    + [_case(a, np.float32, m, i64) for a in ('bilinear', 'cubic')
       for m in MODES for i64 in (False, True)]
    # the TwoProduct's edges in the source values and the lattice
    + [_case(a, np.float32, m, False, source='edge')
       for a in ('bilinear', 'cubic') for m in ('fast', 'masked')]
    + [_case('nearest', np.float32, 'masked', False, source='edge')]
    + [_case(a, np.float32, m, False, lattice='tiny')
       for a, m in (('nearest', 'fast'), ('bilinear', 'fast'),
                    ('cubic', 'masked'))]
    + [_case(a, np.float32, m, i64, lattice='huge')
       for a, m, i64 in (('nearest', 'fast', False),
                         ('cubic', 'fast', False),
                         ('cubic', 'unmasked-wrap', True),
                         ('bilinear', 'masked-wrap', False))]
    + [_case('cubic', np.float32, m, False, lattice='far', source='edge')
       for m in ('unmasked-wrap', 'masked-wrap')])

# arguments warp_launch refuses, with either index width: changes to a
# 46,400^2 uint8 nearest warp
REFUSED = (('output side 2^24 + 1', {'out_w': 2 ** 24 + 1}),
           ('a lattice row of 7,265 columns', {'gw': 7265}),
           ('a wrap without its period', {'wraps': 1}),
           ('3-byte elements', {'elem_size': 3}),
           ('cubic on 1-byte elements', {'algorithm': 2}),
           ('algorithm 5', {'algorithm': 5}))
# (h, w, gh, gw, out_h, out_w) -> whether the warp takes 64-bit indices
INDEX_SHAPES = [
    ((3760, 3760, 472, 472, 3660, 3660), False),
    ((10980, 10980, 345, 345, 10980, 10980), False),
    ((46400, 46400, 460, 460, 3660, 3660), True),
    ((1, 2 ** 31, 2, 2, 1, 1), True),
    ((2, 2, 2, 2, 46341, 46341), True),
    ((2, 2, 2, 2, 46340, 46340), False)]

# warp_kernel.cuh's Operands: what two_prod's call site knows
OPERANDS = {'bounded': 0, 'any-a': 1, 'any-b': 2, 'unknown': 3}
FMA_MIN_PRODUCT = 2.0 ** -100
FMA_MAX_OPERAND = 2.0 ** 100


def compile_host_library(out_dir):
    """g++ tests/warp_host/warp_host.cpp (the kernels' header included)
    into a library."""
    lib = os.path.join(out_dir, 'libwarp_host.so')
    cmd = ['g++', '-std=c++17', '-O2', '-ffp-contract=off', '-shared',
           '-fPIC', '-Wall', '-Wno-unknown-pragmas', '-I', HOST, '-I', CSRC,
           os.path.join(HOST, 'warp_host.cpp'), '-o', lib]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'warning' not in proc.stderr, proc.stderr
    return lib


# ---- inputs ---------------------------------------------------------------

def _lattice(rng, kind, shift):
    """The double-float32 lattice (u_hi, u_lo, v_hi, v_lo) of window-
    relative source coordinates. 'smooth': nodes of the top half on exact
    multiples of 1/4 px (outputs on integer and half-integer coordinates:
    the ambiguity bands), the rest smooth with noise. 'tiny': u's hi the
    same at every node and v's hi a multiple of 1/2 px a row, their lo
    parts about 1e-30 apart, so a lerp's difference is about 1e-30.
    'far': u past 2^24 (no bound on the taps' weights). 'huge': u about
    1e31 apart (beyond the FMA's operand bound), v smooth.
    ``shift`` moves u west (negative columns for a wrapping source)."""
    from proteus_tpu_torch.geo.warp import _dd_split
    gh = len(range(0, OUT_H + 2 * SPACING, SPACING))
    gw = len(range(0, OUT_W + 2 * SPACING, SPACING))
    gi = np.arange(gh, dtype=np.float64)[:, None] * SPACING
    gj = np.arange(gw, dtype=np.float64)[None, :] * SPACING
    exact = gi < OUT_H / 2
    u = np.where(exact, 0.75 * gj + 0.125 * gi + 1.0,
                 0.83 * gj + 0.013 * gi + rng.uniform(-0.4, 0.4, (gh, gw))
                 + 1e-4 * gj ** 2)
    v = np.where(exact, 0.5 * gi + 0.25 * gj + 0.5,
                 0.79 * gi - 0.021 * gj + rng.uniform(-0.4, 0.4, (gh, gw)))
    u_hi, u_lo = _dd_split(u + shift)
    v_hi, v_lo = _dd_split(v - 1.0)
    if kind == 'tiny':
        u_hi = np.full((gh, gw), 12.25 + shift, np.float32)
        u_lo = rng.uniform(-1e-30, 1e-30, (gh, gw)).astype(np.float32)
        v_hi = np.broadcast_to(0.5 * gi, (gh, gw)).astype(np.float32)
        v_lo = rng.uniform(-1e-30, 1e-30, (gh, gw)).astype(np.float32)
    elif kind == 'far':
        # past 2^24: no dd floor error bound, the taps' weights unbounded
        u_hi, u_lo = _dd_split(3e7 * (1 + u / 64) + shift)
    elif kind == 'huge':
        u_hi = rng.uniform(-1e31, 1e31, (gh, gw)).astype(np.float32)
        u_lo = (u_hi * rng.uniform(-2.0 ** -26, 2.0 ** -26, (gh, gw))
                ).astype(np.float32)
    return u_hi, u_lo, v_hi, v_lo


EDGE_VALUES = np.array(
    [0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45, 1.1754942e-38, np.inf,
     -np.inf, np.nan, 3e38, -3e38, 1e30, -2e30, 1e-30, 7.0], np.float32)


def _source(rng, dtype, kind):
    base = rng.normal(120.0, 50.0, (H, W))
    if np.dtype(dtype).kind in 'ui':
        return np.clip(base, 0, 250).astype(dtype)
    data = base.astype(dtype)
    if kind == 'edge':
        # every other pixel one of the edge values
        pick = rng.random((H, W)) < 0.5
        data[pick] = rng.choice(EDGE_VALUES, int(pick.sum()))
    else:
        # NaN and inf under no declared nodata
        data[rng.random((H, W)) < 0.03] = np.nan
        data[rng.random((H, W)) < 0.01] = np.inf
    return data


def _bits_equal(got, want):
    """Bit for bit (signed zeros included) but NaN payloads: x86 keeps the
    first NaN operand's sign, and the kernel and the twin order some
    operands differently."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype.kind != 'f':
        return np.array_equal(got, want)
    nan = np.isnan(want)
    return (np.array_equal(np.isnan(got), nan) and np.array_equal(
        np.where(nan, 0, got).view(np.uint8),
        np.where(nan, 0, want).view(np.uint8)))


def run_case(lib, spec):
    """One warp through the compiled kernel and the plain twin; raises
    AssertionError where they differ."""
    from proteus_tpu_torch.geo.warp import device_resample_plain
    from proteus_tpu_torch.ops import warp_kernel
    rng = np.random.default_rng(zlib.crc32(json.dumps(spec).encode()))
    wraps, masked = spec['wraps'], spec['masked']
    dtype = np.dtype(spec['dtype'])
    lat = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                _lattice(rng, spec['lattice'], -W / 2 if wraps else 0.0))
    data = torch.from_numpy(_source(rng, dtype, spec['source']))
    valid = torch.from_numpy(rng.random((H, W)) > 0.15) if masked else None
    fill = float('nan') if dtype.kind == 'f' else 7
    args = (data, valid, lat, SPACING, OUT_H, OUT_W, spec['algorithm'], fill,
            wraps, W if wraps else None)
    warp_kernel.check(*args[:4], spec['algorithm'])
    want_out, want_amb = device_resample_plain(*args)
    out = torch.empty_like(want_out)
    amb = torch.empty_like(want_amb)
    launch = warp_kernel.launch_args(*args, out, amb)
    assert not lib.warp_index64(*launch[6:10], *launch[11:13],
                                *launch[16:18]), 'the warp took 64-bit indices'
    entry = lib.warp_launch_int64 if spec['index64'] else lib.warp_launch
    err = entry(*launch, None)
    assert err == 0, f'warp_launch returned {err}'
    assert _bits_equal(out.numpy(), want_out.numpy()), \
        f'out differs in {int((out != want_out).sum())} px'
    assert torch.equal(amb, want_amb), \
        f'amb differs in {int((amb != want_amb).sum())} px'
    if spec['lattice'] == 'smooth' and spec['source'] == 'normal':
        assert want_amb.any(), 'no pixel on an ambiguity band'


# ---- two_prod -------------------------------------------------------------

def _operands(rng, n, bounded):
    """n float32 operands: a third random over the exponents (below 2^24
    where ``bounded``, NaN included), a third subnormal or near the
    underflow and overflow limits, a third the special values."""
    hi = 23 if bounded else 127
    e = rng.integers(-149, hi + 1, n)
    x = rng.uniform(1.0, 2.0, n) * np.exp2(e.astype(np.float64))
    edge = np.concatenate([
        rng.integers(1, 2 ** 23, n // 3).astype(np.uint32).view(np.float32),
        np.exp2(rng.integers(-130, -100, n // 3).astype(np.float64))
        * rng.uniform(1, 2, n // 3)])
    if not bounded:
        edge = np.concatenate([
            edge, np.exp2(rng.integers(95, 128, n // 3).astype(np.float64))
            * rng.uniform(1, 2, n // 3)])
    special = [0.0, -0.0, np.nan, 2.0 ** -149, 2.0 ** -126, 2.0 ** 23]
    if not bounded:
        special += [np.inf, -np.inf, 3.4028235e38, 2.0 ** 100,
                    2.0 ** 100 * (1 + 2.0 ** -23), 2.0 ** 116]
    pick = rng.random(n) < 1 / 3
    x[pick] = rng.choice(edge, int(pick.sum()))
    pick = rng.random(n) < 1 / 3
    x[pick] = rng.choice(special, int(pick.sum()))
    with np.errstate(over='ignore'):
        x = x.astype(np.float32)
    return np.where(rng.random(n) < 0.5, -x, x).astype(np.float32)


def run_two_prod(lib, ops, n=300_000):
    """two_prod<ops> against core/eft.py::two_prod on n operand pairs of
    the call sites' contract, a quarter of them with |a b| within a factor
    of 8 of 2^-100; the counts of pairs the guard gives the FMA and of
    pairs where either result differs."""
    from proteus_tpu_torch.core.eft import two_prod
    rng = np.random.default_rng(OPERANDS[ops] + 2026)
    a = _operands(rng, n, bounded=ops not in ('any-a', 'unknown'))
    b = _operands(rng, n, bounded=ops not in ('any-b', 'unknown'))
    # products at the FMA's lower limit
    k = n // 4
    ea = np.frexp(a[:k].astype(np.float64))[1]
    eb = np.clip(-100 - ea + rng.integers(-3, 4, k), -149, 23)
    b[:k] = np.where(np.isfinite(a[:k]) & (a[:k] != 0),
                     rng.uniform(0.5, 1.0, k) * np.exp2(eb.astype(float)),
                     b[:k]).astype(np.float32)
    p = np.empty(n, np.float32)
    e = np.empty(n, np.float32)
    f = ctypes.POINTER(ctypes.c_float)
    lib.warp_two_prod(a.ctypes.data_as(f), b.ctypes.data_as(f), n,
                      OPERANDS[ops], p.ctypes.data_as(f), e.ctypes.data_as(f))
    want_p, want_e = (t.numpy() for t in two_prod(torch.from_numpy(a),
                                                  torch.from_numpy(b)))
    bad = ~(_elementwise_same(p, want_p) & _elementwise_same(e, want_e))
    with np.errstate(invalid='ignore', over='ignore'):
        fma = ~(np.abs(want_p) < FMA_MIN_PRODUCT) | (a == 0) | (b == 0)
        if ops == 'any-a':
            fma &= np.abs(a) <= FMA_MAX_OPERAND
        if ops == 'any-b':
            fma &= ~((np.abs(b) > FMA_MAX_OPERAND) & np.isfinite(b))
    if ops == 'unknown':
        fma[:] = False
    return {'pairs': n, 'fma': int(fma.sum()), 'dekker': int((~fma).sum()),
            'differ': int(bad.sum()),
            'first': [float(a[bad][0]), float(b[bad][0])] if bad.any()
            else None}


def _elementwise_same(x, y):
    return (x.view(np.uint32) == y.view(np.uint32)) | (np.isnan(x)
                                                         & np.isnan(y))


# ---- the worker: a fresh process without jax -------------------------------

def worker(lib_path, out_path):
    torch.set_num_threads(1)
    from proteus_tpu_torch.ops import warp_kernel
    lib = warp_kernel._bind(ctypes.CDLL(lib_path))
    lib.warp_mxcsr.restype = ctypes.c_uint
    lib.warp_launch_int64.argtypes = lib.warp_launch.argtypes
    lib.warp_index64.argtypes = [ctypes.c_longlong] * 6 + [
        ctypes.c_int, ctypes.c_longlong]
    lib.warp_two_prod.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
    results = {'jax_loaded': 'jax' in sys.modules,
               'mxcsr': lib.warp_mxcsr(), 'cases': {}, 'two_prod': {}}
    for name, spec in CASES.items():
        try:
            run_case(lib, spec)
            results['cases'][name] = 'ok'
        except AssertionError as exc:
            results['cases'][name] = str(exc)
    for ops in OPERANDS:
        results['two_prod'][ops] = run_two_prod(lib, ops)
    # arguments warp_launch refuses before it touches memory
    one = ctypes.c_void_p(1)
    base = dict(h=46400, w=46400, gh=10, gw=10, shift=3, out_h=64, out_w=64,
                algorithm=0, elem_size=1, wraps=0, full_width=0)
    results['refusals'] = {}
    for what, change in REFUSED:
        a = {**base, **change}
        results['refusals'][what] = [
            entry(one, None, one, one, one, one, a['h'], a['w'], a['gh'],
                  a['gw'], a['shift'], a['out_h'], a['out_w'], a['algorithm'],
                  a['elem_size'], 0, a['wraps'], a['full_width'], one, one,
                  None)
            for entry in (lib.warp_launch, lib.warp_launch_int64)]
    results['index64'] = {
        str(shape): [lib.warp_index64(*shape, wraps, width)
                     for wraps, width in ((0, 0), (1, 2 ** 31), (0, 2 ** 31))]
        for shape, _ in INDEX_SHAPES}
    results['mxcsr_after'] = lib.warp_mxcsr()
    with open(out_path, 'w') as fh:
        json.dump(results, fh)


@pytest.fixture(scope='module')
def host(tmp_path_factory):
    """The compiled kernels run over every case in a fresh process."""
    out_dir = str(tmp_path_factory.mktemp('warp_host'))
    lib = compile_host_library(out_dir)
    out = os.path.join(out_dir, 'results.json')
    env = {**os.environ, 'PYTHONPATH': REPO}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), lib,
                           out], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as fh:
        return json.load(fh)


@pytest.mark.parametrize('name', list(CASES))
def test_kernel_matches_the_plain_twin(host, name):
    assert host['cases'][name] == 'ok'


@pytest.mark.parametrize('ops', list(OPERANDS))
def test_two_prod_is_dekkers(host, ops):
    got = host['two_prod'][ops]
    assert got['differ'] == 0, got
    # the guarded sites take both paths on these operands; kUnknown only
    # Dekker's
    assert got['dekker'] > got['pairs'] // 20
    assert got['fma'] > got['pairs'] // 5 or ops == 'unknown'


def test_fresh_process_keeps_subnormals(host):
    assert not host['jax_loaded']
    for mxcsr in (host['mxcsr'], host['mxcsr_after']):
        assert mxcsr != 0xffffffff
        assert mxcsr & (1 << 15) == 0, f'flush-to-zero set: {mxcsr:#x}'
        assert mxcsr & (1 << 6) == 0, f'denormals-are-zero set: {mxcsr:#x}'


def test_launch_refuses_what_no_kernel_takes(host):
    got = host['refusals']
    assert got == {what: [1, 1] for what, _ in REFUSED}


@pytest.mark.parametrize('shape,wide', INDEX_SHAPES)
def test_index_width_follows_the_sizes(host, shape, wide):
    # a period of 2^31 counts where the source wraps
    assert host['index64'][str(shape)] == [int(wide), 1, int(wide)]


if __name__ == '__main__':
    worker(sys.argv[1], sys.argv[2])
