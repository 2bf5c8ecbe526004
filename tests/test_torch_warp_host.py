"""The device warp's CUDA kernels on the CPU: ``ops/csrc/warp_kernel.cuh``
compiled with g++ behind the ``cuda_runtime.h`` stand-in of
``tests/warp_host/`` (a block runs as one thread, the ``_rn`` intrinsics
are the IEEE operations, ``-ffp-contract=off``), bound and fed by
``ops/warp_kernel.py`` as on the card, and held against
``geo/warp.py::device_resample_plain`` bit for bit but NaN payloads in
every template instantiation: nearest with elements of 1, 2, 4 and 8
bytes, bilinear and cubic in the fast, unmasked-wrap and masked modes,
each with 32- and 64-bit indices and in each layout of a block: an
output row, and a column chunk with the float32 row and column numbers
(the 64-bit indices and the chunks through an entry of their own: the
dispatch takes them only at 2^31 elements, for lattice rows wider than a
block's shared memory and past 2^24); then sources of +-0, subnormals,
+-inf, NaN and +-3e38, lattices whose differences are about 1e-30 and
1e31, which take the TwoProduct's Dekker path, and lattice rows wider
than a block's shared memory, staged in column chunks. ``two_prod``
itself is held against ``core/eft.py::two_prod`` (Dekker's) on operands
aimed at its guard's edges, the kernel's cells and column lerps against
the twin's float32 column numbers around 2^24, 2^25 and 2^30, and its
chunking, through ``warp_kernel.chunking``, against the widths it must
take. The compiled code and the plain twin run in a process of their own
that has not imported jax, with the thread's flush-to-zero and
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


# (out_h, out_w, spacing): the small grid, and lattice rows of 10,982
# columns (spacing 1) and of 7,502 (spacing 8, 60,000 px wide), past a
# block's 7,264 staged columns: two and three column chunks a row, the
# second's boundaries inside a lattice cell
GEOMETRIES = {'small': (OUT_H, OUT_W, SPACING), 'wide1': (3, 10980, 1),
              'wide8': (3, 60000, 8)}


# warp_kernel.cuh's Layouts, which warp_launch_as forces: an output row
# (the main paths), a column chunk
LAYOUTS = {'rows': 0, 'chunks': 1}


def _case(algorithm, dtype, mode, index64, lattice='smooth',
          source='normal', layout=None, geometry='small'):
    wraps, masked = MODES[mode]
    name = (f'{algorithm}-{np.dtype(dtype).name}-{mode}-'
            f'int{64 if index64 else 32}')
    if layout:
        name += f'-{layout}'
    if lattice != 'smooth' or source != 'normal':
        name += f'-{lattice}-lattice-{source}-source'
    spec = dict(algorithm=algorithm, dtype=np.dtype(dtype).name,
                wraps=wraps, masked=masked, index64=index64, lattice=lattice,
                source=source)
    # (the spec seeds the case's data: keys only where not the default)
    if layout:
        spec['layout'] = layout
    if geometry != 'small':
        name += '-{}x{}-spacing-{}'.format(*GEOMETRIES[geometry])
        spec['geometry'] = geometry
    return name, spec


CASES = dict(
    # every instantiation: warp_nearest_kernel<T, I, layout>,
    # warp_kernel_kernel<taps, mode, I, layout>
    [_case('nearest', d, m, i64, layout=k) for d in NEAREST_DTYPES
     for m in ('fast', 'masked-wrap') for i64 in (False, True)
     for k in (None, 'chunks')]
    + [_case(a, np.float32, m, i64, layout=k)
       for a in ('bilinear', 'cubic') for m in MODES for i64 in (False, True)
       for k in (None, 'chunks')]
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
       for m in ('unmasked-wrap', 'masked-wrap')]
    # lattice rows staged in column chunks
    + [_case(a, d, m, False, geometry=g) for g in ('wide1', 'wide8')
       for a, d, m in (('nearest', np.uint8, 'fast'),
                       ('nearest', np.int16, 'masked'),
                       ('cubic', np.float32, 'fast'),
                       ('cubic', np.float32, 'masked'),
                       ('cubic', np.float32, 'masked-wrap'))])

# arguments warp_launch refuses, with either index width: changes to a
# 46,400^2 uint8 nearest warp
REFUSED = (('output side 2^31', {'out_w': 2 ** 31}),
           ('a lattice row of 2^31 columns', {'gw': 2 ** 31}),
           ('2 x (2^31 - 1) blocks',
            {'out_h': 2 ** 31 - 1, 'out_w': 8000, 'gw': 10 ** 5, 'shift': 0}),
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
# (gw, spacing, out_h, out_w) -> (output columns a block, blocks): whole
# rows, the widest whole row, chunks of W = 7,261 spacing + 1 columns
# (phase 3e's too), and past 2^24, where the chunks keep a slack of 128
CHUNKINGS = [((472, 8, 3660, 3660), (3660, 3660)),
             ((345, 32, 10980, 10980), (10980, 10980)),
             ((7264, 1, 3, 7262), (7262, 3)),
             ((7265, 1, 3, 7263), (7262, 6)),
             ((10982, 1, 256, 10980), (7262, 512)),
             ((7502, 8, 3, 60000), (58089, 6)),
             ((7502, 8, 256, 60000), (58089, 512)),
             ((2 ** 21 + 515, 8, 2, 2 ** 24 + 4099), (57961, 580)),
             ((2 ** 24 + 4101, 1, 2, 2 ** 24 + 4099), (7134, 4706)),
             ((3, 8, 2 ** 24 + 5, 7), (7, 2 ** 24 + 5)),
             ((10 ** 5, 1, 2 ** 31 - 1, 8000), (7134, 2 ** 32 - 2)),
             ((2 ** 20, 2 ** 12, 5, 2 ** 31 - 1), (29740929, 365))]
# cells and column lerps: windows of k around 2^24, 2^25 and 2^30, at
# spacings 1, 8 and 2^12, on a short lattice (every k clamped) and on one
# that holds every k's cell
CELL_WINDOWS = [2 ** 24, 2 ** 25, 2 ** 30]
CELL_SPACINGS = [1, 8, 2 ** 12]
CELL_HALF_WIDTH = 2048

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

def _lattice(rng, kind, shift, geometry='small'):
    """The double-float32 lattice (u_hi, u_lo, v_hi, v_lo) of window-
    relative source coordinates over one of GEOMETRIES. 'smooth': nodes of
    the top half on exact multiples of 1/4 px (outputs on integer and
    half-integer coordinates: the ambiguity bands; a wide grid's columns
    squeezed onto the window by a power of two), the rest smooth with
    noise. 'tiny': u's hi the
    same at every node and v's hi a multiple of 1/2 px a row, their lo
    parts about 1e-30 apart, so a lerp's difference is about 1e-30.
    'far': u past 2^24 (no bound on the taps' weights). 'huge': u about
    1e31 apart (beyond the FMA's operand bound), v smooth.
    ``shift`` moves u west (negative columns for a wrapping source)."""
    from proteus_tpu_torch.geo.warp import _dd_split
    out_h, out_w, spacing = GEOMETRIES[geometry]
    gh = len(range(0, out_h + 2 * spacing, spacing))
    gw = len(range(0, out_w + 2 * spacing, spacing))
    gi = np.arange(gh, dtype=np.float64)[:, None] * spacing
    gj = np.arange(gw, dtype=np.float64)[None, :] * spacing \
        * 2.0 ** np.floor(np.log2(OUT_W / out_w))
    exact = gi < out_h / 2
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
    geometry = spec.get('geometry', 'small')
    out_h, out_w, spacing = GEOMETRIES[geometry]
    lat = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in
                _lattice(rng, spec['lattice'], -W / 2 if wraps else 0.0,
                         geometry))
    data = torch.from_numpy(_source(rng, dtype, spec['source']))
    valid = torch.from_numpy(rng.random((H, W)) > 0.15) if masked else None
    fill = float('nan') if dtype.kind == 'f' else 7
    args = (data, valid, lat, spacing, out_h, out_w, spec['algorithm'], fill,
            wraps, W if wraps else None)
    warp_kernel.check(*args[:4], spec['algorithm'])
    warp_kernel.check_launch(lib, *args[2:6], wraps, args[9])
    if geometry != 'small':
        assert lat[0].shape[1] > warp_kernel.MAX_STAGED_COLUMNS
    want_out, want_amb = device_resample_plain(*args)
    out = torch.empty_like(want_out)
    amb = torch.empty_like(want_amb)
    launch = warp_kernel.launch_args(*args, out, amb)
    assert not lib.warp_index64(*launch[6:10], *launch[11:13],
                                *launch[16:18]), 'the warp took 64-bit indices'
    if spec['index64'] or 'layout' in spec:
        err = lib.warp_launch_as(int(spec['index64']),
                                 LAYOUTS.get(spec.get('layout'), -1),
                                 *launch, None)
    else:
        err = lib.warp_launch(*launch, None)
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


# ---- cells and column lerps past 2^24 ---------------------------------------

def _twin_column_numbers(center):
    """The plain twin's float32 column numbers torch.arange(n,
    dtype=torch.float32) of the window of k around ``center``: sliced from
    the whole arange up to 2^25 + 2^11 (134 MB), past it the float32
    rounding to nearest of k, which those windows show to be the same."""
    k = np.arange(center - CELL_HALF_WIDTH, center + CELL_HALF_WIDTH)
    rounded = torch.from_numpy(k.astype(np.float64)).to(torch.float32)
    if center <= 2 ** 25:
        ranged = torch.arange(int(k[-1]) + 1, dtype=torch.float32)[k[0]:]
        assert torch.equal(ranged, rounded)
        return k, ranged
    return k, rounded


def run_cells(lib, center, spacing, clamps, floats):
    """The kernel's cells and column lerps (warp_columns) against the
    plain twin's, bit for bit but NaN payloads, on the window of k around
    ``center``: the twin's floor(f), clamped to the lattice's last cell,
    f - float32(k0), and g0 + (g1 - g0) w by ``_dd_lerp``. The lerps' end
    points are values of any exponent, differences near 2^100, and, where
    a clamped weight passes 2^28, differences that bring the product
    within 2^-11 of the float32 overflow, where Dekker's partial products
    overflow and the FMA's error term does not. Returns what differs and
    the share of weights past 2^24."""
    from proteus_tpu_torch.geo.warp import _dd_lerp, f32
    k, f = _twin_column_numbers(center)
    if not floats:
        k, f = k[k < 2 ** 24], f[torch.from_numpy(k < 2 ** 24)]
    n = 5 if clamps else (center + CELL_HALF_WIDTH) // spacing + 2
    # the plain twin: device_resample_plain's fj, j0 and wj
    fj = f * f32(1.0 / spacing, f)
    j0 = torch.floor(fj).to(torch.int64).clamp(0, n - 2)
    wj = fj - j0.to(torch.float32)
    w = wj.numpy()
    rng = np.random.default_rng(center + spacing + 2 * clamps + floats)
    scale = np.float32(2.0) ** rng.integers(-100, 101, (len(k), 2))
    ends = (rng.normal(0, 1, (len(k), 2)) * scale).astype(np.float32)
    big = rng.random(len(k)) < 0.3
    ends[big, 1] = (rng.uniform(1.0, 2.0, int(big.sum()))
                    * 2.0 ** 99).astype(np.float32)
    edge = (rng.random(len(k)) < 0.4) & (w >= 2 ** 28)
    ends[edge, 0] = 0.0
    ends[edge, 1] = (np.finfo(np.float32).max / w[edge].astype(np.float64)
                     * (1 - rng.uniform(0, 2.0 ** -11, int(edge.sum())))
                     ).astype(np.float32)
    # (hi, lo) pairs
    lo = ends * np.float32(2.0 ** -30) \
        * rng.uniform(-1, 1, (len(k), 2)).astype(np.float32)
    g0 = np.ascontiguousarray(np.stack([ends[:, 0], lo[:, 0]], 1))
    g1 = np.ascontiguousarray(np.stack([ends[:, 1], lo[:, 1]], 1))
    k32 = k.astype(np.int32)
    k0 = np.empty(len(k), np.int32)
    weight, hi, lo = (np.empty(len(k), np.float32) for _ in range(3))
    ptr = (lambda a: a.ctypes.data_as(ctypes.c_void_p))
    lib.warp_columns(ptr(k32), len(k), spacing.bit_length() - 1, n,
                     int(floats), ptr(g0), ptr(g1), ptr(k0), ptr(weight),
                     ptr(hi), ptr(lo))
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (g0[:, 0], g0[:, 1], g1[:, 0], g1[:, 1])]
    want_hi, want_lo = (x.numpy() for x in
                        _dd_lerp((t[0], t[1]), (t[2], t[3]), wj))
    bad = {'k0': int((k0 != j0.numpy()).sum()),
           'weight': int((~_elementwise_same(weight, w)).sum()),
           'lerp': int((~(_elementwise_same(hi, want_hi)
                          & _elementwise_same(lo, want_lo))).sum())}
    return {'differ': bad, 'past_2_24': float(np.mean(w >= 2 ** 24)),
            'near_overflow': int(edge.sum())}


# ---- the worker: a fresh process without jax -------------------------------

def worker(lib_path, out_path):
    torch.set_num_threads(1)
    from proteus_tpu_torch.ops import warp_kernel
    lib = warp_kernel._bind(ctypes.CDLL(lib_path))
    lib.warp_mxcsr.restype = ctypes.c_uint
    lib.warp_launch_as.argtypes = [ctypes.c_int] * 2 \
        + lib.warp_launch.argtypes
    lib.warp_columns.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int] + [ctypes.c_void_p] * 6
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
            for entry in (lib.warp_launch,
                          lambda *args: lib.warp_launch_as(
                              1, LAYOUTS['chunks'], *args))]
    results['index64'] = {
        str(shape): [lib.warp_index64(*shape, wraps, width)
                     for wraps, width in ((0, 0), (1, 2 ** 31), (0, 2 ** 31))]
        for shape, _ in INDEX_SHAPES}
    results['chunking'] = {str(sizes): warp_kernel.chunking(lib, *sizes)
                           for sizes, _ in CHUNKINGS}
    results['cells'] = {
        f'{center}-{spacing}-{clamps}-{floats}': run_cells(
            lib, center, spacing, clamps, floats)
        for center in CELL_WINDOWS for spacing in CELL_SPACINGS
        for clamps in (True, False) for floats in (True, False)
        if floats or center == 2 ** 24}
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


@pytest.mark.parametrize('gw,spacing,out_h,out_w',
                         [sizes for sizes, _ in CHUNKINGS])
def test_chunks_are_the_wrappers(host, gw, spacing, out_h, out_w):
    """The wrapper's chunking (``warp_kernel.chunking``, which reads the
    C entry's ``chunk_columns`` and ``blocks``) takes the widths the
    staging model in tests/test_torch_warp_kernel.py checks."""
    from proteus_tpu_torch.ops import warp_kernel
    sizes = (gw, spacing, out_h, out_w)
    chunk, blocks = dict(CHUNKINGS)[sizes]
    assert host['chunking'][str(sizes)] == [chunk, blocks]
    assert blocks == out_h * -(-out_w // chunk)
    assert chunk == out_w or gw > warp_kernel.MAX_STAGED_COLUMNS


@pytest.mark.parametrize('center', CELL_WINDOWS)
@pytest.mark.parametrize('spacing', CELL_SPACINGS)
@pytest.mark.parametrize('clamps', (True, False), ids=('short', 'long'))
def test_cells_are_the_twins_float32_numbers(host, center, spacing, clamps):
    """k0, the weight and the column lerp of every k of the window, from
    the float32 numbers (the chunks) and, below 2^24, from the shift (an
    output row), as the twin computes them from torch.arange(n,
    dtype=torch.float32) / spacing."""
    for floats in (True, False):
        got = host['cells'].get(f'{center}-{spacing}-{clamps}-{floats}')
        if got is None:
            assert not floats and center > 2 ** 24
            continue
        assert got['differ'] == {'k0': 0, 'weight': 0, 'lerp': 0}, got
    # a short lattice clamps every weight to about k / spacing, which
    # passes 2^24 (Dekker's split) in some windows
    got = host['cells'][f'{center}-{spacing}-{clamps}-True']
    assert (got['past_2_24'] > 0) == (
        clamps and center / spacing > 2 ** 24 - CELL_HALF_WIDTH)
    # and past 2^28, where products come within 2^-11 of the overflow
    assert (got['near_overflow'] > 0) == (clamps
                                          and center / spacing > 2 ** 28)


@pytest.mark.parametrize('shape,wide', INDEX_SHAPES)
def test_index_width_follows_the_sizes(host, shape, wide):
    # a period of 2^31 counts where the source wraps
    assert host['index64'][str(shape)] == [int(wide), 1, int(wide)]


if __name__ == '__main__':
    worker(sys.argv[1], sys.argv[2])
