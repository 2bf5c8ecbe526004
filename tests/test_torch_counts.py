"""The coverage counts of the port (n_valid, n_cloud_and_valid and
n_not_ocean a tile) against proteus_tpu's and numpy's, tolerance 0.

- The wrappers (``wtr_layers``, ``wtr_layers_batched`` with and without a
  window) and both campaign steps on CPU tensors, which take the plain
  path (``coverage_counts``), against JAX's data-parallel and spatial
  steps (``use_pallas=False``, on its CPU devices) and a numpy count of
  the same predicate: the three modes, with and without ocean, int16,
  float32 and device-scaled bands, sides whose H * W is no multiple of 8,
  B of 1 and 3, 2 and 4 row shards.
- The per-pixel kernel's own count logic, ``ops/csrc/tile_counts.cuh``,
  built with g++ behind ``tests/warp_host/cuda_runtime.h`` (a block is one
  thread, or a host thread a lane for the warps' votes and the block's
  flush) with the kernel's group loop (``tests/warp_host/
  counts_host.cpp``): both launches of an unwindowed stack (the 8-pixel
  body and the one-pixel tail, or the one-pixel body alone) and windows of
  rows, against numpy, for H * W from 1 to 64, 1001 x 1003 and 3660 x
  3660, B from 1 to 5, threads whose grid-stride loops cross tiles; and
  H * W from 1 to 64 and 999 x 997 on blocks of 64, 96 and 256 lanes.
- The callers take the counts from the wrappers: neither the orchestrator
  nor the campaign computes them itself.
"""

import ast
import ctypes
import os
import subprocess

import jax
import numpy as np
import pytest
import torch

from proteus_tpu.models.dswx.chain import DswxChainConfig as JaxConfig
from proteus_tpu.parallel import campaign as jcampaign
from proteus_tpu.parallel.mesh import make_tile_mesh as jax_mesh
from proteus_tpu.parallel.mesh import make_tile_space_mesh as jax_space_mesh
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.ops import wtr_kernel
from proteus_tpu_torch.parallel import campaign as tcampaign
from proteus_tpu_torch.parallel.mesh import (make_tile_mesh,
                                             make_tile_space_mesh)
from test_torch_batched import KINDS, T, batch_inputs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = os.path.join(REPO, 'tests', 'warp_host')
CSRC = os.path.join(REPO, 'proteus_tpu_torch', 'ops', 'csrc')
MODES = wtr_kernel.MODES
CLOUD_BITS = {'mask': 2 | 4 | 8, 'ignore': 2 | 8, 'cover': 2 | 8}


def numpy_counts(fmask, invalid, mode, ocean=None, ocean_in_valid=True):
    """[B, 3] counts of [B, H, W] planes: valid = ~invalid and, with the
    ocean in it, ocean != 0; cloudy = Fmask bit 1 or 3, and bit 2 in
    'mask' mode; not ocean = ocean != 0, every pixel without an ocean
    plane."""
    invalid = invalid.astype(bool)
    land = np.ones_like(invalid) if ocean is None else ocean != 0
    valid = ~invalid & (land if ocean_in_valid else True)
    cloudy = (fmask & CLOUD_BITS[mode]) != 0
    return np.stack([valid.sum((1, 2)), (valid & cloudy).sum((1, 2)),
                     land.sum((1, 2))], axis=1).astype(np.int64)


def got_counts(out):
    return np.stack([np.asarray(out[name]) for name in wtr_kernel.COUNTS],
                    axis=-1).astype(np.int64)


def inputs(seed, kind, b, h, w):
    """batch_inputs with more invalid pixels and a shoreline of ocean."""
    x = batch_inputs(seed, kind, b, h, w)
    rng = np.random.default_rng(seed + 1000)
    x['invalid'] = rng.random((b, h, w)) < 0.2
    x['ocean'][:, :, : w // 3] = 0
    return x


def band_args(x, kind):
    kw = {}
    if kind == 'device_scale':
        kw = dict(scales=T(x['scales']), offsets=T(x['offsets']))
    return [T(a) for a in x['bands']], kw


# ---- the wrappers' plain path against numpy -------------------------------

WRAPPER_CASES = [(mode, kind, ocean) for mode in MODES for kind in KINDS
                 for ocean in (False, True)]


@pytest.mark.parametrize('mode,kind,ocean', WRAPPER_CASES)
def test_wrapper_counts_match_numpy(mode, kind, ocean):
    """``wtr_layers_batched`` (full and minimal outputs, whole tiles and a
    window of rows, with and without the ocean in the valid pixels) and
    ``wtr_layers`` a tile, on 13 x 21 tiles (H * W % 8 = 1), B = 3 with
    the ocean and 1 without."""
    b, h, w = (3 if ocean else 1), 13, 21
    x = inputs(WRAPPER_CASES.index((mode, kind, ocean)), kind, b, h, w)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
    bands, kw = band_args(x, kind)
    if ocean:
        kw['ocean'] = T(x['ocean'])
    oc = x['ocean'] if ocean else None
    for minimal in (False, True):
        for window in (None, (4, 6)):
            for in_valid in (True, False):
                out = wtr_kernel.wtr_layers_batched(
                    *bands, T(x['fmask']), T(x['invalid']), cfg,
                    minimal=minimal, window=window, ocean_in_valid=in_valid,
                    **kw)
                rows = slice(*(window and (window[0], sum(window))
                               or (0, h)))
                want = numpy_counts(x['fmask'][:, rows], x['invalid'][:, rows],
                                    mode, None if oc is None else oc[:, rows],
                                    in_valid)
                np.testing.assert_array_equal(
                    got_counts(out), want,
                    err_msg=f'minimal={minimal} window={window} '
                            f'ocean_in_valid={in_valid}')
                assert all(out[name].dtype == torch.int64
                           for name in wtr_kernel.COUNTS)
    want = numpy_counts(x['fmask'], x['invalid'], mode, oc)
    for k in range(b):
        tile = [a[k] for a in x['bands']]
        if kind == 'device_scale':
            tile = [x['scales'][k, j] * (a.astype(np.float32)
                                         - x['offsets'][k, j])
                    for j, a in enumerate(tile)]
        out = wtr_kernel.wtr_layers(
            *[T(a) for a in tile], T(x['fmask'][k]), T(x['invalid'][k]),
            cfg, ocean=T(oc[k]) if ocean else None)
        assert all(out[name].dim() == 0 for name in wtr_kernel.COUNTS)
        np.testing.assert_array_equal(got_counts(out), want[k])


# ---- the data-parallel step against JAX's and numpy ------------------------

STEP_CASES = WRAPPER_CASES


@pytest.mark.parametrize('mode,kind,ocean', STEP_CASES)
def test_data_parallel_step_counts_match_jax(mode, kind, ocean):
    """The port's step (its totals and each tile's counts, and the
    wrapper's n_not_ocean of the same stack) == JAX's ``make_campaign_step``
    (jnp chain) on one CPU device == numpy; valid pixels not ocean either
    (campaign.py:218-231). 11 x 19 tiles (H * W % 8 = 1), B = 3 with the
    ocean and 1 without."""
    b, h, w = (3 if ocean else 1), 11, 19
    x = inputs(100 + STEP_CASES.index((mode, kind, ocean)), kind, b, h, w)
    scaled = kind == 'device_scale'
    kw = dict(with_ocean=ocean, float_inputs=kind != 'int16',
              device_scale=scaled)
    args = [*x['bands'], x['fmask'], x['invalid']]
    if scaled:
        args += [x['scales'], x['offsets']]
    if ocean:
        args.append(x['ocean'])
    out, totals = tcampaign.make_campaign_step(
        DswxChainConfig(mask_adjacent_to_cloud_mode=mode),
        make_tile_mesh([torch.device('cpu')]), **kw)(*args)
    jout, jtotals = jcampaign.make_campaign_step(
        JaxConfig(mask_adjacent_to_cloud_mode=mode),
        jax_mesh(jax.devices()[:1]), use_pallas=False, **kw)(*args)
    want = numpy_counts(x['fmask'], x['invalid'], mode,
                        x['ocean'] if ocean else None)
    for j, name in enumerate(wtr_kernel.COUNTS[:2]):
        got = np.array([int(t) for t in out[name]])
        np.testing.assert_array_equal(got, np.asarray(jout[name]), name)
        np.testing.assert_array_equal(got, want[:, j], name)
    assert totals == {k: int(v) for k, v in jtotals.items()}
    assert totals == {'n_valid_total': int(want[:, 0].sum()),
                      'n_cloud_and_valid_total': int(want[:, 1].sum()),
                      'n_tiles_total': b}
    bands, bkw = band_args(x, kind)
    layers = wtr_kernel.wtr_layers_batched(
        *bands, T(x['fmask']), T(x['invalid']),
        DswxChainConfig(mask_adjacent_to_cloud_mode=mode),
        ocean=T(x['ocean']) if ocean else None, minimal=True, **bkw)
    np.testing.assert_array_equal(layers['n_not_ocean'].numpy(),
                                  np.asarray(jout['n_not_ocean']))


# ---- the spatial step against JAX's and numpy ------------------------------

SPATIAL_CASES = [(mode, ocean, shards) for mode in MODES
                 for ocean in (False, True) for shards in (2, 4)]


@pytest.mark.parametrize('mode,ocean,shards', SPATIAL_CASES)
def test_spatial_step_counts_match_jax(mode, ocean, shards):
    """The port's spatial step on 1 x ``shards`` CPU devices (each shard's
    windowed launch counts its own rows, never the halo) == JAX's
    ``make_spatial_campaign_step`` (jnp chain) == numpy; valid pixels
    without the ocean term (campaign.py:441-452). 68 x 19 tiles (H * W %
    8 = 4; 17 or 34 rows a shard), the band kinds in turn, B = 3 with the
    ocean and 1 without."""
    n = SPATIAL_CASES.index((mode, ocean, shards))
    kind = KINDS[n % len(KINDS)]
    b, h, w = (3 if ocean else 1), 68, 19
    x = inputs(200 + n, kind, b, h, w)
    scaled = kind == 'device_scale'
    kw = dict(with_ocean=ocean, float_inputs=kind != 'int16',
              device_scale=scaled)
    args = [*x['bands'], x['fmask'], x['invalid']]
    if scaled:
        args += [x['scales'], x['offsets']]
    if ocean:
        args.append(x['ocean'])
    out, totals = tcampaign.make_spatial_campaign_step(
        DswxChainConfig(mask_adjacent_to_cloud_mode=mode),
        make_tile_space_mesh(1, shards, [torch.device('cpu')] * shards),
        **kw)(*args)
    _, jtotals = jcampaign.make_spatial_campaign_step(
        JaxConfig(mask_adjacent_to_cloud_mode=mode),
        jax_space_mesh(1, shards, jax.devices()[:shards]), use_pallas=False,
        **kw)(*args)
    assert not set(wtr_kernel.COUNTS) & set(out)
    want = numpy_counts(x['fmask'], x['invalid'], mode)
    assert totals == {k: int(v) for k, v in jtotals.items()}
    assert totals == {'n_valid_total': int(want[:, 0].sum()),
                      'n_cloud_and_valid_total': int(want[:, 1].sum()),
                      'n_tiles_total': b}


# ---- the callers ------------------------------------------------------------

@pytest.mark.parametrize('module', ['runtime/orchestrator.py',
                                    'parallel/campaign.py'])
def test_callers_take_the_counts_from_the_wrapper(module):
    """Neither the single-tile orchestrator nor the campaign steps count
    themselves: no call of ``coverage_counts`` or
    ``compute_preliminary_cloud_layer`` (the plain twins') in them."""
    path = os.path.join(REPO, 'proteus_tpu_torch', module)
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = {node.id for node in ast.walk(tree) if isinstance(node, ast.Name)}
    names |= {node.attr for node in ast.walk(tree)
              if isinstance(node, ast.Attribute)}
    names |= {alias.name for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) for alias in node.names}
    assert not names & {'coverage_counts', 'compute_preliminary_cloud_layer'}


# ---- the kernel's count logic, built with g++ ---------------------------------

@pytest.fixture(scope='module')
def host_lib(tmp_path_factory):
    """tests/warp_host/counts_host.cpp (tile_counts.cuh included) built
    with g++ and loaded."""
    out = str(tmp_path_factory.mktemp('counts_host') / 'libcounts_host.so')
    cmd = ['g++', '-std=c++17', '-O2', '-shared', '-fPIC', '-pthread',
           '-Wall', '-Wno-unknown-pragmas', '-I', HOST, '-I', CSRC,
           os.path.join(HOST, 'counts_host.cpp'), '-o', out]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert 'warning' not in proc.stderr, proc.stderr
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.count_launch.argtypes = [p] * 3 + [i] * 8 + [ctypes.c_longlong, i,
                                                     p]
    lib.count_launch.restype = i
    lib.count_tile_at.argtypes = [p] + [ctypes.c_longlong] * 3 + [p, p]
    lib.count_tile_at.restype = i
    return lib


def host_counts(lib, fmask, invalid, mode, ocean=None, ocean_in_valid=True,
                window=None, vec=8, threads=1 << 28, lanes=1):
    """The [B, 3] counts of the host-built kernel logic, on blocks of one
    thread or of ``lanes`` host threads."""
    b, h, w = fmask.shape
    row0, rows = window or (0, h)
    counts = np.full((b, 3), 12345, np.uint64)  # the launcher zeroes them
    err = lib.count_launch(
        fmask.ctypes.data, invalid.ctypes.data,
        None if ocean is None else ocean.ctypes.data, b, h, w, row0, rows,
        vec, int(mode == 'mask'), int(ocean_in_valid), threads, lanes,
        counts.ctypes.data)
    assert err == 0
    return counts.astype(np.int64)


def planes(seed, b, h, w):
    rng = np.random.default_rng(seed)
    fmask = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    invalid = (rng.random((b, h, w)) < 0.3).astype(np.uint8)
    invalid[rng.random((b, h, w)) < 0.05] = 7  # any nonzero byte is invalid
    ocean = (rng.random((b, h, w)) < 0.7).astype(np.uint8)
    return fmask, invalid, ocean


def windows(h):
    """Row windows of a block of h rows: a shard's own rows inside its
    halo, and the first and last rows alone."""
    out = {(0, 1), (h - 1, 1)} if h > 1 else set()
    if h > 2:
        out |= {(1, h - 2), (h // 3, max(1, h // 3))}
    return sorted(out)


@pytest.mark.parametrize('hw', range(1, 65))
def test_kernel_counts_small_tiles(host_lib, hw):
    """Tiles of H * W = 1 .. 64 px (a group of 8 straddles one tile end
    or, below 8 px, several), B = 1 .. 5: the 8-pixel body with its
    one-pixel tail and the one-pixel body alone, with 1, 3 and one thread a
    group (a thread's loop crosses tiles), every mode and ocean rule; and
    windows of rows."""
    w = max(d for d in range(1, 9) if hw % d == 0)
    h = hw // w
    for b in range(1, 6):
        fmask, invalid, ocean = planes(hw * 10 + b, b, h, w)
        for mode, oc, in_valid in (('mask', None, True),
                                   ('ignore', ocean, True),
                                   ('cover', ocean, False)):
            want = numpy_counts(fmask, invalid, mode, oc, in_valid)
            for vec in (8, 1):
                for threads in (1, 3, 1 << 28):
                    np.testing.assert_array_equal(
                        host_counts(host_lib, fmask, invalid, mode, oc,
                                    in_valid, vec=vec, threads=threads),
                        want, err_msg=f'{h}x{w} B={b} {mode} vec={vec} '
                                      f'threads={threads}')
            for row0, rows in windows(h):
                own = slice(row0, row0 + rows)
                want = numpy_counts(fmask[:, own], invalid[:, own], mode,
                                    None if oc is None else oc[:, own],
                                    in_valid)
                for vec in ((4, 1) if w % 4 == 0 else (1,)):
                    np.testing.assert_array_equal(
                        host_counts(host_lib, fmask, invalid, mode, oc,
                                    in_valid, (row0, rows), vec, 3), want,
                        err_msg=f'{h}x{w} B={b} window ({row0}, {rows}) '
                                f'vec={vec}')


@pytest.mark.parametrize('hw', range(1, 65))
def test_kernel_counts_warp_lanes(host_lib, hw):
    """The same tiles on blocks of 64 and 96 host threads, a lane each (2
    and 3 warps): the warps' votes on whether their lanes' runs are of one
    tile (warp_run), a straddling warp's per-lane adds, and warp 0's sum of
    the warps' runs (flush_block) as the card runs them; grids of one and
    of two blocks, whose threads' loops cross tile ends, in both launches
    of a stack and in windows of rows."""
    w = max(d for d in range(1, 9) if hw % d == 0)
    h = hw // w
    for b, (mode, in_valid), lanes in zip(
            (1, 3, 5), (('mask', True), ('ignore', True), ('cover', False)),
            (64, 96, 64)):
        fmask, invalid, ocean = planes(hw * 100 + b, b, h, w)
        want = numpy_counts(fmask, invalid, mode, ocean, in_valid)
        for vec in (8, 1):
            for threads in (lanes, 2 * lanes):
                np.testing.assert_array_equal(
                    host_counts(host_lib, fmask, invalid, mode, ocean,
                                in_valid, vec=vec, threads=threads,
                                lanes=lanes),
                    want, err_msg=f'{h}x{w} B={b} {mode} vec={vec} '
                                  f'threads={threads} lanes={lanes}')
        for row0, rows in windows(h)[-1:]:
            own = slice(row0, row0 + rows)
            np.testing.assert_array_equal(
                host_counts(host_lib, fmask, invalid, mode, ocean, in_valid,
                            (row0, rows), 1, lanes, lanes),
                numpy_counts(fmask[:, own], invalid[:, own], mode,
                             ocean[:, own], in_valid),
                err_msg=f'{h}x{w} B={b} window ({row0}, {rows})')


def test_kernel_counts_warp_lanes_straddling_stack(host_lib):
    """999 x 997 at B = 2 (H * W % 8 = 3: the tile end inside a group) on 4
    blocks of 256 host threads, the card's block, each thread's loop
    crossing the tile end, both launches; and a window of rows."""
    h, w, b = 999, 997, 2
    fmask, invalid, ocean = planes(h * w, b, h, w)
    want = numpy_counts(fmask, invalid, 'mask', ocean)
    for vec in (8, 1):
        np.testing.assert_array_equal(
            host_counts(host_lib, fmask, invalid, 'mask', ocean, vec=vec,
                        threads=1024, lanes=256), want, err_msg=f'vec={vec}')
    own = slice(250, 500)
    np.testing.assert_array_equal(
        host_counts(host_lib, fmask, invalid, 'mask', ocean, True, (250, 250),
                    1, 1024, 256),
        numpy_counts(fmask[:, own], invalid[:, own], 'mask', ocean[:, own]))


@pytest.mark.parametrize('h,w,b', [(1001, 1003, 5), (3660, 3660, 2)])
def test_kernel_counts_full_tiles(host_lib, h, w, b):
    """1001 x 1003 (H * W % 8 = 3: tile ends inside groups and a
    one-pixel tail) at B = 5 and 3660 x 3660 at B = 2: both launches, a
    grid of few threads whose loops cross every tile, and the spatial
    step's windows of 4 row shards in their 17-row halos (the 4-pixel body
    where W % 4 == 0)."""
    fmask, invalid, ocean = planes(h + b, b, h, w)
    want = numpy_counts(fmask, invalid, 'mask', ocean)
    for vec, threads in ((8, 1 << 28), (8, 1001), (1, 1 << 28)):
        np.testing.assert_array_equal(
            host_counts(host_lib, fmask, invalid, 'mask', ocean, vec=vec,
                        threads=threads), want,
            err_msg=f'vec={vec} threads={threads}')
    hl = h // 4
    vec = 4 if w % 4 == 0 else 1
    for j in range(4):
        a0, a1 = max(0, j * hl - 17), min(h, (j + 1) * hl + 17)
        block = [np.ascontiguousarray(p[:, a0:a1])
                 for p in (fmask, invalid, ocean)]
        own = slice(j * hl, (j + 1) * hl)
        want = numpy_counts(fmask[:, own], invalid[:, own], 'cover',
                            ocean[:, own], False)
        np.testing.assert_array_equal(
            host_counts(host_lib, *block[:2], 'cover', block[2], False,
                        (j * hl - a0, hl), vec), want, err_msg=f'shard {j}')


@pytest.mark.parametrize('hw', [1, 2, 3, 7, 8, 9, 1001 * 1003, 3660 * 3660,
                                10980 * 10980, 46400 * 46400, 2 ** 31 - 1,
                                2 ** 31 + 1, 2 ** 32 - 1])
def test_tile_at_is_floor_division(host_lib, hw):
    """tile_at == i // hw, and the pixels to the tile's end == hw - i %
    hw, on every pixel next to a tile end and at random: the 32-bit
    multiply-high of a stack below 2^32 pixels, and the float64 reciprocal
    of one up to 2^20 tiles or 2^40 pixels."""
    rng = np.random.default_rng(hw % 1000)
    for top, small in ((min(2 ** 32 - 1, hw * 2 ** 20), True),
                       (min(2 ** 40, hw * 2 ** 20), False)):
        ends = np.unique(rng.integers(0, top // hw, 200)) * hw
        i = np.concatenate([ends - 1, ends, ends + 1, [top - 1],
                            rng.integers(0, top, 200)])
        i = np.ascontiguousarray(i[(i >= 0) & (i < top)], dtype=np.int64)
        tile = np.zeros(len(i), np.int32)
        rest = np.zeros(len(i), np.int64)
        stack = top if small else 2 ** 40
        took = host_lib.count_tile_at(i.ctypes.data, len(i), hw, stack,
                                      tile.ctypes.data, rest.ctypes.data)
        assert took == small
        np.testing.assert_array_equal(tile, (i // hw).astype(np.int32))
        np.testing.assert_array_equal(rest, hw - i % hw)

