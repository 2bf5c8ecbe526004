"""The device warp's resampler: the port's ``device_resample_plain`` (the
CUDA kernel's plain twin) against the reference's ``_device_resample``
(JAX on the CPU) on the same seeded inputs, ``out`` and ``amb`` at
tolerance 0 (bit for bit but NaN payloads) in every template case of
``ops/csrc/warp_kernel.cu``: nearest with elements of 1, 2 and 4 bytes,
with and without a wrap and a validity mask; bilinear and cubic in the
fast, unmasked-wrap and masked accumulation modes. The lattices put pixels
on integer and half-integer coordinates, so ``amb`` is populated, and the
float sources hold NaN and inf under no declared nodata (the vmin / vmax
trackers). Then the dispatch of ``device_resample`` (CPU tensors take the
plain twin and launch nothing; any other device reaches the kernel's
wrapper, never the twin), the wrapper's checks, and a numpy model of the
kernel's row staging at the main path's sizes and spacings.
"""

import os
import re
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


def _lattice(rng, shift):
    """A double-float32 lattice of window-relative source coordinates.
    Nodes of the top half sit on exact multiples of 1/4 px (outputs on
    integer and half-integer coordinates: the ambiguity bands), the rest
    are smooth with noise; ``shift`` moves u west (negative columns for a
    wrapping source)."""
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


@pytest.mark.parametrize(
    'algorithm,dtype,wraps,masked', NEAREST + KERNELS,
    ids=[f'{a}-{np.dtype(d).name}-{MODES[w, m]}'
         for a, d, w, m in NEAREST + KERNELS])
def test_plain_twin_matches_the_reference(algorithm, dtype, wraps, masked):
    rng = np.random.default_rng(zlib.crc32(
        f'{algorithm} {np.dtype(dtype).name} {wraps} {masked}'.encode()))
    lat = _lattice(rng, -W / 2 if wraps else 0.0)
    data = _source(rng, dtype, holes=np.dtype(dtype).kind == 'f')
    valid = rng.random((H, W)) > 0.15 if masked else None
    fill = float('nan') if np.dtype(dtype).kind == 'f' else 7
    args = (SPACING, OUT_H, OUT_W, algorithm, fill, wraps, W)
    want_out, want_amb = _device_resample(
        jnp.asarray(data), None if valid is None else jnp.asarray(valid),
        tuple(jnp.asarray(a) for a in lat), *args)
    got_out, got_amb = device_resample_plain(
        torch.from_numpy(data),
        None if valid is None else torch.from_numpy(valid),
        tuple(torch.from_numpy(a) for a in lat), *args)
    want_out, want_amb = np.asarray(want_out), np.asarray(want_amb)
    got_out, got_amb = got_out.numpy(), got_amb.numpy()
    assert got_out.dtype == want_out.dtype and got_out.shape == (OUT_H, OUT_W)
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


LIMITS = {  # lattice columns, out_h, out_w, wraps, full_width -> launches
    'the widest staged row, 7,264 columns': (7264, 41, 53, False, None, True),
    'a row of 7,265 columns': (7265, 41, 53, False, None, False),
    'an output side of 2^24': (8, 2 ** 24, 1, False, None, True),
    'an output side of 2^24 + 1': (8, 1, 2 ** 24 + 1, False, None, False),
    'an empty output': (8, 0, 53, False, None, False),
    'a wrap without its period': (8, 41, 53, True, None, False),
    'a wrap with its period': (8, 41, 53, True, 45, True),
}


@pytest.mark.parametrize('name', LIMITS)
def test_launch_limits(name):
    """``check_launch`` takes a lattice row of at most 7,264 columns (the
    staged row and its column differences, 32 B a column, in 227 KiB of
    shared memory) and output sides in [1, 2^24], and raises beyond."""
    gw, out_h, out_w, wraps, full_width, launches = LIMITS[name]
    lat = tuple(torch.empty((2, gw), device='meta') for _ in range(4))
    if launches:
        warp_kernel.check_launch(lat, out_h, out_w, wraps, full_width)
    else:
        with pytest.raises(ValueError, match='device warp'):
            warp_kernel.check_launch(lat, out_h, out_w, wraps, full_width)


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


def _staging(out_h, out_w, spacing):
    """The kernel's launch restated: block i (one output row) stages
    lattice rows i0, i0 + 1 at every column k that its threads t take
    (k = t, t + THREADS, ... < gw) and the differences of neighbouring
    staged columns, then thread t writes the row's pixels
    j = t, t + THREADS, ... < out_w from the staged columns j0, j0 + 1.
    i0 and j0 as the kernel computes them (i >> log2(spacing), clamped
    to the lattice's last cell). Returns the lattice shape, the rows each
    block reads, the columns it stages and the pixels it writes."""
    gh = len(range(0, out_h + 2 * spacing, spacing))
    gw = len(range(0, out_w + 2 * spacing, spacing))
    shift = spacing.bit_length() - 1
    i = np.arange(out_h)
    i0 = np.minimum(i >> shift, gh - 2)
    t = np.arange(THREADS)[:, None]
    staged = t + THREADS * np.arange(-(-gw // THREADS))[None, :]
    staged = np.unique(staged[staged < gw])
    written = t + THREADS * np.arange(-(-out_w // THREADS))[None, :]
    written = written[written < out_w]
    j = np.sort(written)
    j0 = np.minimum(j >> shift, gw - 2)
    return (gh, gw), i0, staged, j, j0


@pytest.mark.parametrize('spacing', (8, 16, 32))
@pytest.mark.parametrize('out_h,out_w', [(3660, 3660), (3760, 3760),
                                         (10980, 10980), (1001, 777)])
def test_row_staging_covers_every_pixels_lattice_nodes(out_h, out_w,
                                                       spacing):
    (gh, gw), i0, staged, j, j0 = _staging(out_h, out_w, spacing)
    # the lattice rows a block reads exist
    assert (i0 >= 0).all() and (i0 + 1 <= gh - 1).all()
    # the threads stage every lattice column once, so j0 and j0 + 1 of
    # every pixel the block writes are staged
    assert np.array_equal(staged, np.arange(gw))
    assert np.isin(j0, staged).all() and np.isin(j0 + 1, staged).all()
    # every pixel of the row is written once: out[i * out_w + j] covers
    # the grid once over the blocks
    assert np.array_equal(j, np.arange(out_w))
    # the staged row fits the block's shared memory
    assert 32 * gw <= _kernel_constant('kMaxSmem')
    assert gw <= warp_kernel.MAX_STAGED_COLUMNS
    # i0, j0 and the weights as the plain twin computes them
    inv = warp.f32(1.0 / spacing, torch.zeros(0))
    for n, idx, g in ((out_h, i0, gh), (out_w, j0, gw)):
        f = torch.arange(n, dtype=torch.float32) * inv
        want = torch.floor(f).to(torch.int64).clamp(0, g - 2)
        assert np.array_equal(idx, want.numpy())
        weight = (f - want.to(torch.float32)).numpy()
        assert ((weight >= 0) & (weight < 1)).all()
        # the kernel's weight from the integers: (k - k0 spacing) * inv
        shift = spacing.bit_length() - 1
        numerator = (np.arange(n) - (idx << shift)).astype(np.float32)
        assert np.array_equal((numerator * np.float32(inv)).view(np.uint32),
                              weight.view(np.uint32))


@pytest.mark.parametrize('dx,spacing', [(30.0, 8), (10.0, 32), (20.0, 16)])
def test_main_path_spacings(dx, spacing):
    """The spacings the staging model covers are those the main path's
    grids get: the DEM and CGLS at 30 m, WorldCover's 10 m grid."""
    from proteus_tpu_torch.geo.crs import CRS
    assert _auto_grid_spacing(CRS.from_epsg(32615), dx) == spacing
