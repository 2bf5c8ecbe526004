"""The warps' float64 re-decision (``proteus_tpu_torch/geo/warp.py::
_resample_block``) reads only the taps of the pixels it is asked for.

``_resample_block`` gathers each pixel's taps from the window in the
window's own dtype and promotes only them to float64. It is held bit for
bit against a frozen copy of the whole-window path it replaced, which
converted the window to float64 and padded it (edge rows, edge or
wrapping columns; validity False in the pads) before it gathered; every
resampler, source dtype, nodata kind, validity, wrapping and pixels past
every edge of the window. The re-decision allocates nothing of the
window's size, and its counter ``warp.redecide_taps.<algorithm>`` counts
the taps of the pixels a CPU device warp re-decides.
"""

import tracemalloc

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu_torch.geo import warp
from proteus_tpu_torch.runtime import profiling


def _cubic_weights_frozen(t):
    a = -0.5
    def w(x):
        ax = np.abs(x)
        return np.where(
            ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
            np.where(ax < 2,
                     a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a,
                     0.0))
    return [w(t + 1), w(t), w(1 - t), w(2 - t)]


def _gather_frozen(data, valid, rows, cols, wraps, width):
    h, w = data.shape
    if wraps:
        cols = cols % width
    inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    r = np.clip(rows, 0, h - 1)
    c = np.clip(cols, 0, w - 1)
    vals = data[r, c]
    ok = inb if valid is None else (inb & valid[r, c])
    return vals, ok


def _resample_block_frozen(fdata, valid, u, v, algorithm, fill, wraps,
                           width, all_valid=False):
    """The whole-window float64 path, as it was: ``fdata`` is the window
    converted to float64, padded whole before the taps are read, and each
    cubic weight raises its tap distance to the third power twice."""
    h, w = fdata.shape
    if algorithm == 'nearest':
        rows = np.floor(v).astype(np.int64)
        cols = np.floor(u).astype(np.int64)
        vals, ok = _gather_frozen(fdata, None if all_valid else valid,
                                  rows, cols, wraps, width)
        return np.where(ok, vals, fill)

    uc = u - 0.5
    vc = v - 0.5
    iu = np.floor(uc).astype(np.int64)
    iv = np.floor(vc).astype(np.int64)
    fu = uc - iu
    fv = vc - iv

    if algorithm == 'bilinear':
        taps = [(0, 1 - fv), (1, fv)]
        cols_w = [(0, 1 - fu), (1, fu)]
    else:
        wv = _cubic_weights_frozen(fv)
        wu = _cubic_weights_frozen(fu)
        taps = list(zip((-1, 0, 1, 2), wv))
        cols_w = list(zip((-1, 0, 1, 2), wu))

    PAD = 2
    x_mode = 'wrap' if wraps else 'edge'
    dpad = np.pad(np.pad(fdata, ((PAD, PAD), (0, 0)), mode='edge'),
                  ((0, 0), (PAD, PAD)), mode=x_mode)
    center_in = (u >= 0) & (u <= w) & (v >= 0) & (v <= h)
    if wraps:
        iu = iu % width
        center_in = (v >= 0) & (v <= h)
    rbase = np.clip(iv, -PAD, h + PAD - 1) + PAD
    cbase = np.clip(iu, -PAD, w + PAD - 1) + PAD

    def _tap_rows(dr):
        return np.clip(rbase + dr, 0, h + 2 * PAD - 1)

    def _tap_cols(dc):
        return np.clip(cbase + dc, 0, w + 2 * PAD - 1)

    if all_valid and not wraps:
        acc = np.zeros(u.shape, dtype=np.float64)
        for dr, wr in taps:
            rr = _tap_rows(dr)
            for dc, wc in cols_w:
                acc += (wr * wc) * dpad[rr, _tap_cols(dc)]
        return np.where(center_in, acc, fill)

    if all_valid:
        vpad = None
    else:
        vpad = np.pad(valid, ((PAD, PAD), (0, 0)), mode='constant',
                      constant_values=False)
        if wraps:
            vpad = np.pad(vpad, ((0, 0), (PAD, PAD)), mode='wrap')
        else:
            vpad = np.pad(vpad, ((0, 0), (PAD, PAD)), mode='constant',
                          constant_values=False)
    acc = np.zeros(u.shape, dtype=np.float64)
    wacc = np.zeros(u.shape, dtype=np.float64)
    for dr, wr in taps:
        rr = _tap_rows(dr)
        for dc, wc in cols_w:
            cc = _tap_cols(dc)
            wgt = wr * wc
            vals = dpad[rr, cc]
            if vpad is not None:
                ok = vpad[rr, cc]
                acc += np.where(ok, vals * wgt, 0.0)
                wacc += np.where(ok, wgt, 0.0)
            else:
                acc += vals * wgt
                wacc += wgt
    with np.errstate(invalid='ignore', divide='ignore'):
        res = acc / wacc
    return np.where(center_in & (wacc > 1e-9), res, fill)


# (dtype, nodata, all_valid): no nodata is all valid; a nodata value may
# mark pixels of the window or none of them
SOURCES = [(np.uint8, None, True), (np.uint8, 255, False),
           (np.uint8, 255, True), (np.int16, None, True),
           (np.int16, -9999, False), (np.int16, -9999, True),
           (np.float32, None, True), (np.float32, -9999.0, False),
           (np.float32, -9999.0, True), (np.float32, np.nan, False),
           (np.float32, np.nan, True)]
CASES = [(algorithm, wraps, *source)
         for algorithm in ('nearest', 'bilinear', 'cubic')
         for wraps in (False, True) for source in SOURCES]


def _window(rng, dtype, nodata, all_valid, h, w):
    if dtype == np.uint8:
        data = rng.integers(0, 255, (h, w)).astype(dtype)
    elif dtype == np.int16:
        data = rng.integers(-500, 4000, (h, w)).astype(dtype)
    else:
        data = (rng.standard_normal((h, w)) * 800.0).astype(dtype)
    if nodata is None:
        return data, None
    if not all_valid:
        # scattered nodata pixels, and a block of them on an edge
        data[rng.random((h, w)) < 0.05] = nodata
        data[:, :3] = nodata
    if np.isnan(nodata):
        valid = ~np.isnan(data)
    else:
        valid = data != nodata
    assert bool(valid.all()) == all_valid
    return data, valid


def _pixels(rng, h, w, n):
    """Scattered window-relative coordinates: most inside, some within a
    few pixels past every edge, some on exact half and whole pixel
    positions, and some far outside the window."""
    u = rng.uniform(-6.0, w + 6.0, n)
    v = rng.uniform(-6.0, h + 6.0, n)
    k = n // 8
    u[:k] = np.round(u[:k] * 2.0) / 2.0
    v[:k] = np.round(v[:k] * 2.0) / 2.0
    u[k:k + 8] = [-1e5, 1e5, 0.0, w, -2.5, w + 2.5, 0.25, w - 0.25]
    v[k:k + 8] = [1e5, -1e5, h, 0.0, h + 2.5, -2.5, h - 0.25, 0.25]
    return u, v


@pytest.mark.parametrize('algorithm,wraps,dtype,nodata,all_valid', CASES)
def test_taps_match_the_whole_window_float64_path(algorithm, wraps, dtype,
                                                  nodata, all_valid):
    seed = CASES.index((algorithm, wraps, dtype, nodata, all_valid))
    rng = np.random.default_rng(20240 + seed)
    h, w = int(rng.integers(64, 513)), int(rng.integers(64, 513))
    data, valid = _window(rng, dtype, nodata, all_valid, h, w)
    if valid is None:
        # the host warp's mask of a source without nodata
        valid = np.ones(data.shape, dtype=bool)
    n = int(rng.integers(1000, 4001))
    u, v = _pixels(rng, h, w, n)
    if wraps:
        # a wrapping source's coordinates come modulo its width
        u = u % w
    fill = nodata if nodata is not None else 0
    got = warp._resample_block(data, valid, u, v, algorithm, fill,
                               wraps=wraps, width=w, all_valid=all_valid)
    want = _resample_block_frozen(data.astype(np.float64), valid, u, v,
                                  algorithm, fill, wraps=wraps, width=w,
                                  all_valid=all_valid)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize('algorithm', ['nearest', 'cubic'])
@pytest.mark.parametrize('dtype', [np.uint8, np.float32])
def test_the_redecision_allocates_nothing_of_the_windows_size(algorithm,
                                                              dtype):
    """A float64 copy of a 4000² window is 128 MB; re-deciding 100
    pixels of it stays under 1 MB."""
    rng = np.random.default_rng(7)
    side = 4000
    data = rng.integers(1, 200, (side, side)).astype(dtype)
    data[::97, ::89] = 0
    valid = data != 0
    u, v = _pixels(rng, side, side, 100)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        res = warp._resample_block(data, valid, u, v, algorithm, 0,
                                   wraps=False, width=side,
                                   all_valid=False)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert res.shape == (100,)
    assert peak < 1 << 20


SIZE = 64
TAPS = {'nearest': 1, 'bilinear': 4, 'cubic': 16}


@pytest.fixture(scope='module')
def dem(tmp_path_factory):
    return synthetic.make_dem(str(tmp_path_factory.mktemp('redecide')),
                              size=SIZE)


@pytest.mark.parametrize('algorithm', ['bilinear', 'cubic'])
def test_the_taps_counter_is_the_pixels_times_the_taps(dem, algorithm):
    """A CPU device warp (``device_resample_plain``) of the DEM leaves
    pixels to the re-decision, which reads 4 or 16 taps of each."""
    before = profiling.COUNTERS.snapshot()
    gt = synthetic.geotransform()
    warp.warp_to_grid_device(dem, gt, f'EPSG:{synthetic.EPSG}', SIZE, SIZE,
                             resample_algorithm=algorithm,
                             margin_in_pixels=50,
                             device=torch.device('cpu'))
    moved = profiling.Counters.delta(profiling.COUNTERS.snapshot(), before)
    pixels = moved['warp.ambiguous_px']
    assert pixels > 0
    assert moved[f'warp.redecide_taps.{algorithm}'] == \
        pixels * TAPS[algorithm]
    assert not any(k.startswith('warp.redecide_taps.') and
                   k != f'warp.redecide_taps.{algorithm}' for k in moved)
