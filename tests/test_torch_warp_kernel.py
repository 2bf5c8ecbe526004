"""The device warp's resampler: the port's ``device_resample_plain`` (the
CUDA kernel's plain twin) against the reference's ``_device_resample``
(JAX on the CPU) on the same seeded inputs, ``out`` and ``amb`` at
tolerance 0 (bit for bit but NaN payloads) in every template case of
``ops/csrc/warp_kernel.cu``: nearest with elements of 1, 2 and 4 bytes,
with and without a wrap and a validity mask; bilinear and cubic in the
fast, unmasked-wrap and masked accumulation modes; and three on a grid
whose lattice rows pass a block's 7,264 staged columns. The lattices put
pixels on integer and half-integer coordinates, so ``amb`` is populated,
and the float sources hold NaN and inf under no declared nodata (the
vmin / vmax trackers). Then the dispatch of ``device_resample`` (CPU
tensors take the plain twin and launch nothing; any other device reaches
the kernel's wrapper, never the twin), the wrapper's checks and launch
limits, and a numpy model of the kernel's blocks: whole rows at the main
path's sizes and spacings, column chunks of wider lattice rows, and sides
past 2^24.
"""

import os
import re
import subprocess
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteus_tpu.geo.warp import _device_resample
from proteus_tpu_torch.geo import warp
from proteus_tpu_torch.geo.warp import (_auto_grid_spacing, _dd_split,
                                        device_resample,
                                        device_resample_plain)
from proteus_tpu_torch.ops import warp_kernel

torch.set_num_threads(1)

# the source window, the output grid, the lattice spacing
H, W = 37, 45
OUT_H, OUT_W = 41, 53
SPACING = 8


def _lattice(rng, shift, out_h=OUT_H, out_w=OUT_W, spacing=SPACING):
    """A double-float32 lattice of window-relative source coordinates.
    Nodes of the top half sit on exact multiples of 1/4 px (outputs on
    integer and half-integer coordinates: the ambiguity bands; a wide
    grid's columns squeezed onto the window by a power of two), the rest
    are smooth with noise; ``shift`` moves u west (negative columns for a
    wrapping source)."""
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
    return (*_dd_split(u + shift), *_dd_split(v - 1.0))


def _source(rng, dtype, holes):
    base = rng.normal(120.0, 50.0, (H, W))
    if np.dtype(dtype).kind in 'ui':
        return np.clip(base, 0, 250).astype(dtype)
    data = base.astype(dtype)
    if holes:
        # NaN and inf under no declared nodata
        data[rng.random((H, W)) < 0.03] = np.nan
        data[rng.random((H, W)) < 0.01] = np.inf
    return data


# (algorithm, dtype, wraps, with a validity mask): every template case
NEAREST = [('nearest', dtype, wraps, masked)
           for dtype in (np.uint8, np.int16, np.float32)
           for wraps in (False, True) for masked in (False, True)]
KERNELS = [(algorithm, np.float32, wraps, masked)
           for algorithm in ('bilinear', 'cubic')
           for wraps, masked in ((False, False), (True, False),
                                 (False, True), (True, True))]
MODES = {(False, False): 'fast', (True, False): 'unmasked-wrap',
         (False, True): 'masked', (True, True): 'masked-wrap'}
# a grid whose lattice rows (8,002 columns) pass a block's 7,264 staged
# columns, which the reference takes too
WIDE = (3, 8000, 1)
TWIN_CASES = [c + ((OUT_H, OUT_W, SPACING),) for c in NEAREST + KERNELS] + [
    ('nearest', np.uint8, False, False, WIDE),
    ('cubic', np.float32, False, True, WIDE),
    ('bilinear', np.float32, True, False, WIDE)]


@pytest.mark.parametrize(
    'algorithm,dtype,wraps,masked,geometry', TWIN_CASES,
    ids=[f'{a}-{np.dtype(d).name}-{MODES[w, m]}'
         + ('' if g == (OUT_H, OUT_W, SPACING) else '-{}x{}-spacing-{}'
            .format(*g)) for a, d, w, m, g in TWIN_CASES])
def test_plain_twin_matches_the_reference(algorithm, dtype, wraps, masked,
                                          geometry):
    out_h, out_w, spacing = geometry
    key = f'{algorithm} {np.dtype(dtype).name} {wraps} {masked}'
    if geometry != (OUT_H, OUT_W, SPACING):
        key += ' {} {} {}'.format(*geometry)
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    lat = _lattice(rng, -W / 2 if wraps else 0.0, *geometry)
    data = _source(rng, dtype, holes=np.dtype(dtype).kind == 'f')
    valid = rng.random((H, W)) > 0.15 if masked else None
    fill = float('nan') if np.dtype(dtype).kind == 'f' else 7
    args = (spacing, out_h, out_w, algorithm, fill, wraps, W)
    want_out, want_amb = _device_resample(
        jnp.asarray(data), None if valid is None else jnp.asarray(valid),
        tuple(jnp.asarray(a) for a in lat), *args)
    got_out, got_amb = device_resample_plain(
        torch.from_numpy(data),
        None if valid is None else torch.from_numpy(valid),
        tuple(torch.from_numpy(a) for a in lat), *args)
    want_out, want_amb = np.asarray(want_out), np.asarray(want_amb)
    got_out, got_amb = got_out.numpy(), got_amb.numpy()
    assert got_out.dtype == want_out.dtype and got_out.shape == (out_h,
                                                                  out_w)
    if geometry == WIDE:
        assert lat[0].shape[1] > warp_kernel.MAX_STAGED_COLUMNS
    # bit for bit (signed zeros included) but NaN payloads: XLA and PyTorch
    # on the CPU order the operands of an add differently, and x86 keeps
    # the first NaN operand's sign
    nan = np.isnan(want_out)
    np.testing.assert_array_equal(np.isnan(got_out), nan)
    np.testing.assert_array_equal(np.where(nan, 0, got_out).view(np.uint8),
                                  np.where(nan, 0, want_out).view(np.uint8))
    np.testing.assert_array_equal(got_amb, want_amb)
    assert got_amb.any()
    if algorithm != 'nearest':
        assert np.isnan(got_out).any() and np.isfinite(got_out).any()


def _args(rng, algorithm='cubic', dtype=np.float32, masked=False):
    lat = tuple(torch.from_numpy(a) for a in _lattice(rng, 0.0))
    data = torch.from_numpy(_source(rng, dtype, holes=False))
    valid = torch.from_numpy(rng.random((H, W)) > 0.15) if masked else None
    return [data, valid, lat, SPACING, OUT_H, OUT_W, algorithm, 0.0]


@pytest.mark.parametrize('algorithm,dtype,masked', [
    ('nearest', np.uint8, False), ('bilinear', np.float32, True),
    ('cubic', np.float32, False)])
def test_cpu_tensors_take_the_plain_twin(monkeypatch, algorithm, dtype,
                                         masked):
    def no_launch(*args, **kw):
        raise AssertionError('a CPU tensor reached the kernel')
    monkeypatch.setattr(warp_kernel, 'resample', no_launch)
    before = dict(warp_kernel.LAUNCHES)
    args = _args(np.random.default_rng(5), algorithm, dtype, masked)
    got = device_resample(*args)
    want = device_resample_plain(*args)
    assert warp_kernel.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_other_devices_reach_the_kernel_not_the_twin(monkeypatch):
    """A tensor off the CPU goes to the kernel's wrapper, which launches or
    raises; the plain twin never runs there (no fallback)."""
    calls = []

    def no_twin(*args, **kw):
        raise AssertionError('the plain twin ran off the CPU')
    monkeypatch.setattr(warp, 'device_resample_plain', no_twin)
    monkeypatch.setattr(warp_kernel, 'resample',
                        lambda *args: calls.append(args) or 'launched')
    args = _args(np.random.default_rng(6))
    meta = [a.to('meta') if isinstance(a, torch.Tensor) else a
            for a in args]
    meta[2] = tuple(t.to('meta') for t in args[2])
    assert device_resample(*meta, wraps=False, full_width=None) == 'launched'
    assert len(calls) == 1 and calls[0][0].device.type == 'meta'
    # the wrapper itself takes CUDA tensors only, and says so
    monkeypatch.undo()
    with pytest.raises(ValueError, match='CUDA'):
        device_resample(*meta)


def _bad(name):
    """The arguments of a cubic (or nearest) warp, spoiled one way."""
    args = _args(np.random.default_rng(7),
                 'nearest' if name == 'complex128 nearest' else 'cubic')
    data, valid, lat = args[0], args[1], list(args[2])
    if name == 'int16 cubic':
        data = data.to(torch.int16)
    elif name == 'complex128 nearest':
        data = data.to(torch.complex128)
    elif name == 'float64 lattice':
        lat[1] = lat[1].double()
    elif name == 'uint8 validity':
        valid = torch.ones(data.shape, dtype=torch.uint8)
    elif name == 'validity of another shape':
        valid = torch.ones((H, W + 1), dtype=torch.bool)
    elif name == 'non-contiguous data':
        data = data.t().contiguous().t()
    elif name == 'non-contiguous lattice':
        lat[2] = lat[2].t().contiguous().t()
    elif name == 'lattice planes of two shapes':
        lat[3] = lat[3][:, :-1].contiguous()
    elif name == 'a lattice of one row':
        lat = [t[:1].contiguous() for t in lat]
    elif name == 'three lattice planes':
        lat = lat[:3]
    elif name == 'empty data':
        data = data[:0]
    elif name == 'spacing 12':
        args[3] = 12
    elif name == 'validity on another device':
        valid = torch.ones(data.shape, dtype=torch.bool, device='meta')
    elif name == 'lattice on another device':
        lat[0] = lat[0].to('meta')
    elif name == 'unknown algorithm':
        args[6] = 'lanczos'
    args[0], args[1], args[2] = data, valid, tuple(lat)
    return args


BAD = ['int16 cubic', 'complex128 nearest', 'float64 lattice',
       'uint8 validity', 'validity of another shape', 'non-contiguous data',
       'non-contiguous lattice', 'lattice planes of two shapes',
       'a lattice of one row', 'three lattice planes', 'empty data',
       'spacing 12', 'validity on another device',
       'lattice on another device', 'unknown algorithm']


@pytest.mark.parametrize('name', BAD)
def test_the_wrappers_checks_raise(name):
    before = dict(warp_kernel.LAUNCHES)
    with pytest.raises(ValueError, match='device warp'):
        device_resample(*_bad(name))
    assert warp_kernel.LAUNCHES == before


LIMITS = {  # lattice columns, spacing, out_h, out_w, wraps, full_width
    #          -> launches
    'the widest staged row, 7,264 columns':
        (7264, 8, 41, 53, False, None, True),
    'a row of 7,265 columns': (7265, 8, 41, 53, False, None, True),
    'a row of 10,982 columns at spacing 1':
        (10982, 1, 256, 10980, False, None, True),
    'a row of 2^31 - 1 columns': (2 ** 31 - 1, 1, 3, 8000, False, None, True),
    'a row of 2^31 columns': (2 ** 31, 1, 3, 8000, False, None, False),
    'an output side of 2^24': (8, 8, 2 ** 24, 1, False, None, True),
    'an output side of 2^24 + 1': (8, 8, 1, 2 ** 24 + 1, False, None, True),
    'an output side of 2^31 - 1':
        (8, 8, 2 ** 31 - 1, 1, False, None, True),
    'an output side of 2^31': (8, 8, 1, 2 ** 31, False, None, False),
    'more than 2^31 - 1 blocks':
        (10 ** 5, 1, 2 ** 31 - 1, 8000, False, None, False),
    'an empty output': (8, 8, 0, 53, False, None, False),
    'a wrap without its period': (8, 8, 41, 53, True, None, False),
    'a wrap with its period': (8, 8, 41, 53, True, 45, True),
}


@pytest.fixture(scope='module')
def header_lib(tmp_path_factory):
    """``csrc/warp_kernel.cuh`` alone, compiled with g++ behind the
    ``cuda_runtime.h`` stand-in of tests/warp_host: the library exports the
    C entry's chunking (``warp_chunking``), which ``warp_kernel.chunking``
    and ``check_launch`` read."""
    import ctypes
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    lib = str(tmp_path_factory.mktemp('warp_header') / 'libwarp_header.so')
    cmd = ['g++', '-std=c++17', '-O2', '-shared', '-fPIC', '-I',
           os.path.join(repo, 'tests', 'warp_host'), '-I',
           os.path.join(repo, 'proteus_tpu_torch', 'ops', 'csrc'), '-x',
           'c++', '-', '-o', lib]
    proc = subprocess.run(cmd, input='#include <cuda_runtime.h>\n'
                          '#include "warp_kernel.cuh"\n', capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(lib)


@pytest.mark.parametrize('name', LIMITS)
def test_launch_limits(header_lib, name):
    """``check_launch`` takes lattice rows of any width below 2^31 (a
    block stages at most 7,264 columns, 32 B each in 227 KiB of shared
    memory, and a wider row is cut into column chunks) and output sides in
    [1, 2^31 - 1], past 2^24 too, in at most 2^31 - 1 blocks (the C
    entry's count), and raises beyond."""
    gw, spacing, out_h, out_w, wraps, full_width, launches = LIMITS[name]
    lat = tuple(torch.empty((2, gw), device='meta') for _ in range(4))
    args = (lat, spacing, out_h, out_w, wraps, full_width)
    if launches:
        warp_kernel.check_launch(header_lib, *args)
    else:
        with pytest.raises(ValueError, match='device warp'):
            warp_kernel.check_launch(header_lib, *args)


def test_launch_counts_lose_no_update_across_threads():
    """The campaign's prep threads count their launches concurrently."""
    import sys
    import threading
    before = dict(warp_kernel.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [warp_kernel.count('warp_nearest')
                            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert warp_kernel.LAUNCHES['warp_nearest'] == \
            before['warp_nearest'] + 16 * 2000
    finally:
        sys.setswitchinterval(interval)
        warp_kernel.LAUNCHES.update(before)


def test_fill_bits_are_the_plain_twins_fill():
    assert warp_kernel.fill_bits(255, torch.uint8) == 255
    assert warp_kernel.fill_bits(-32768, torch.int16) == 0x8000
    assert warp_kernel.fill_bits(float('nan'), torch.float32) == \
        int(torch.tensor(float('nan')).view(torch.int32)) & 0xFFFFFFFF
    assert warp_kernel.fill_bits(-9999.0, torch.float64) == \
        int(np.array(-9999.0).view(np.uint64))


# ---- a numpy model of the kernel's row staging ----------------------------

def _kernel_constant(name):
    src = os.path.join(os.path.dirname(warp_kernel.__file__), 'csrc',
                       'warp_kernel.cuh')
    with open(src) as fh:
        found = re.search(rf'constexpr int {name} = ([\d *]+);', fh.read())
    # an integer or a product such as 227 * 1024
    return int(np.prod([int(x) for x in found.group(1).split('*')]))


THREADS = _kernel_constant('kThreads')


def _strided(count):
    """The indices a block's threads t take, t, t + THREADS, ... < count,
    in order."""
    t = np.arange(THREADS)[:, None]
    taken = t + THREADS * np.arange(-(-count // THREADS))[None, :]
    return np.sort(taken[taken < count])


def _cells(k, spacing, n, floats):
    """The kernel's cells of rows or columns k on a lattice side of n:
    k >> log2(spacing) (a block an output row), or floor(float32(k) /
    spacing) (a column chunk), clamped to the last cell."""
    if floats:
        below = np.floor(k.astype(np.float32) * np.float32(1.0 / spacing))
        return np.minimum(below.astype(np.int64), n - 2)
    return np.minimum(k >> (spacing.bit_length() - 1), n - 2)


def _twin_cells(numbers, spacing, n):
    """The plain twin's cells and weights of its row or column numbers
    (a slice of torch.arange(side, dtype=torch.float32))."""
    f = numbers * warp.f32(1.0 / spacing, numbers)
    k0 = torch.floor(f).to(torch.int64).clamp(0, n - 2)
    return k0.numpy(), (f - k0.to(torch.float32)).numpy()


# (out_h, out_w, spacing): the main path's grids at their spacings, a
# ragged tile, lattice rows past a block's shared memory (spacing 1 on the
# WorldCover grid, 60,000 px at spacing 8), and sides past 2^24
STAGINGS = [(h, w, s) for s in (8, 16, 32)
            for h, w in ((3660, 3660), (3760, 3760), (10980, 10980),
                         (1001, 777))] + [
    (3, 10980, 1), (256, 10980, 1), (3, 60000, 8),
    (2, 2 ** 24 + 4099, 8), (2, 2 ** 24 + 4099, 1), (2 ** 24 + 4099, 2, 8)]


@pytest.mark.parametrize('out_h,out_w,spacing', STAGINGS)
def test_row_staging_covers_every_pixels_lattice_nodes(header_lib, out_h,
                                                       out_w, spacing):
    """The kernel's launch restated: out_h rows of chunks (``chunking``,
    the C entry's), block b taking row b // chunks and chunk b % chunks, whose
    columns j_a .. j_b its threads write (m = t, t + THREADS, ... <
    width); it stages lattice rows i0, i0 + 1 at columns ka = k0(j_a) ..
    kb = k0(j_b) + 1, the threads taking k = ka + t, ka + t + THREADS, ...
    <= kb. Every pixel's k0 and k0 + 1 are staged by its own block, the
    staged columns fit its shared memory, every pixel is written once, and
    i0, k0 and the weights are the plain twin's: from a shift where a block
    takes an output row, from the float32 numbers in a chunk, and up to
    2^24 the two agree bit for bit."""
    gh = len(range(0, out_h + 2 * spacing, spacing))
    gw = len(range(0, out_w + 2 * spacing, spacing))
    chunk, blocks = warp_kernel.chunking(header_lib, gw, spacing, out_h,
                                         out_w)
    exact = max(out_h, out_w) <= 2 ** 24
    floats = not exact or gw > warp_kernel.MAX_STAGED_COLUMNS
    smem_columns = min(gw, warp_kernel.MAX_STAGED_COLUMNS)
    assert 32 * smem_columns <= _kernel_constant('kMaxSmem')
    # the rows (2^20 at a time): the lattice rows a block reads exist, and
    # are the twin's
    rows = torch.arange(out_h, dtype=torch.float32)
    for start in range(0, out_h, 2 ** 20):
        i = np.arange(start, min(start + 2 ** 20, out_h))
        i0 = _cells(i, spacing, gh, floats)
        assert (i0 >= 0).all() and (i0 + 1 <= gh - 1).all()
        if exact:
            assert np.array_equal(i0, _cells(i, spacing, gh, not floats))
        assert np.array_equal(
            i0, _twin_cells(rows[i[0]:i[-1] + 1], spacing, gh)[0])
    del rows
    # the columns, chunk by chunk
    assert blocks == out_h * -(-out_w // chunk)
    if gw <= warp_kernel.MAX_STAGED_COLUMNS:
        assert chunk == out_w
    columns = torch.arange(out_w, dtype=torch.float32)
    shift = spacing.bit_length() - 1
    j_a = 0
    for c in range(-(-out_w // chunk)):
        assert j_a == c * chunk
        width = min(chunk, out_w - j_a)
        j = j_a + _strided(width)
        # written once: the chunks tile the row
        assert np.array_equal(j, np.arange(j_a, j_a + width))
        j0 = _cells(j, spacing, gw, floats)
        ka, kb = j0[0], j0[-1] + 1
        staged = ka + _strided(kb - ka + 1)
        assert np.array_equal(staged, np.arange(ka, kb + 1))
        assert len(staged) <= smem_columns and kb <= gw - 1
        assert (j0 >= ka).all() and (j0 + 1 <= kb).all()
        # k0 and the weights as the twin computes them
        want_k0, want_weight = _twin_cells(columns[j_a:j_a + width],
                                           spacing, gw)
        assert np.array_equal(j0, want_k0)
        # the chunks' weight, f - float32(k0)
        weight = j.astype(np.float32) * np.float32(1.0 / spacing) \
            - j0.astype(np.float32)
        assert np.array_equal(weight.view(np.uint32),
                              want_weight.view(np.uint32))
        if exact:
            # an output row's from the integers, (k - k0 spacing) * inv:
            # the same cells and bits
            assert np.array_equal(j0, _cells(j, spacing, gw, False))
            numerator = (j - (j0 << shift)).astype(np.float32)
            weight = numerator * np.float32(1.0 / spacing)
            assert np.array_equal(weight.view(np.uint32),
                                  want_weight.view(np.uint32))
            assert ((want_weight >= 0) & (want_weight < 1)).all()
        j_a += width
    assert j_a == out_w


@pytest.mark.parametrize('dx,spacing', [(30.0, 8), (10.0, 32), (20.0, 16)])
def test_main_path_spacings(dx, spacing):
    """The spacings the staging model covers are those the main path's
    grids get: the DEM and CGLS at 30 m, WorldCover's 10 m grid."""
    from proteus_tpu_torch.geo.crs import CRS
    assert _auto_grid_spacing(CRS.from_epsg(32615), dx) == spacing
