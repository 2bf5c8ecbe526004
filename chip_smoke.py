#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits nonzero:

1. device: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: the CUDA kernels and the native TIFF codec, from the sources in
   the checkout (the codec says which DEFLATE library it linked);
3. kernels vs plain: the CUDA kernels against their plain PyTorch versions
   on the same 3660 x 3660 tensors on the card, bit for bit. K1, K2 and K3
   through ``wtr_layers`` in every combination of int16 / float32 bands
   (float32 operands pushed onto the ratio tests' rounding boundaries),
   'mask' / 'ignore' / 'cover' mode (a random and a structured fmask),
   ancillary planes and browse. K4, K5 and K6 through
   ``wtr_layers_batched`` in every combination of int16 / float32 / raw
   int16 with device scale, the three modes, full / minimal outputs and
   B = 1 / 3, with the ancillary planes and browse varied, per-tile scales
   and offsets that differ between the tiles of a batch, and raw int16
   pairs whose scaled ratios land within 2 ULPs of each ratio threshold.
   In every case the coverage counts the per-pixel kernel adds up
   (n_valid, n_cloud_and_valid, n_not_ocean a tile) equal
   ``coverage_counts`` of the same tensors. Then each kernel and its plain version timed with CUDA events, K4+K5+K6
   at B = 1 and B = 4. K6 spatial (phase 3c): B = 2 stacks cut into 4 row
   shards of 915 rows (with the 17-row halo in 'cover'), each windowed
   launch against the plain twin on its padded block, cropped, and the
   joined shards against the unsharded K6 launch, in every band kind x
   mode x ancillaries x browse, each launch's body (4 px a thread in a
   window) against ``wtr_kernel.window_body``, the counts of a window's
   rows (also with valid pixels counted without the ocean term, as the
   spatial step counts them) against ``coverage_counts`` and the shards'
   sums against the unsharded launch's; the 4 windowed launches
   timed against the one unsharded launch, and their pass A and pass B
   apart. The null kernel (phase 3d): the traffic floor
   ``null_fold`` against its plain twin at 3660^2 on int16, float32 and
   mixed inputs, 1, 3 and 8 of them, on an unaligned slice and a ragged
   tail; its time beside the device copy bandwidth. The warp kernel
   (phase 3e): ``device_resample`` against ``device_resample_plain`` on
   the synthetic tile's own sources as ``warp_to_grid_device`` hands them
   over (the DEM with its 50 px margin, cubic, 3760^2; CGLS, nearest,
   3660^2; WorldCover, nearest, 10980^2), the DEM with NaN holes (masked,
   cubic and bilinear), int16 and float32 nearest with a validity mask,
   lattices moved west over a wrapping source, the TwoProduct's edges
   (+-0, subnormals, +-inf, NaN and +-3e38 among the DEM's values under
   cubic and bilinear taps; lattice differences of about 1e-30 and
   lattices scaled by 1e30, which take Dekker's split), a uint8
   window of 46,400^2 (64-bit indices), and geometries past what a block
   stages whole or past 2^24: WorldCover at grid spacing 1 (lattice rows
   of 10,982 columns, also through ``warp_to_grid_device`` itself, against
   the host warp), the DEM cubic on a 256 x 60,000 grid at spacing 8
   (masked, wrapping, both), and 2 x (2^24 + 4,099) outputs, uint8
   nearest and DEM cubic (the rounded float32 row and column numbers); out
   and amb bit for bit, amb's population, one call's peak device memory
   and time, plain against kernel, and the bound;
4. main path: a full-size synthetic HLS tile (3660^2 bands, DEM with its
   50 px margin, 3x WorldCover grid) through
   ``python -m proteus_tpu_torch.cli.dswx_hls``'s ``main`` on ``cuda``
   three times: (c) the default run; (a) 'cover' mode on an Fmask where
   snow meets clear cloud-adjacent pixels, with ocean masking; (b)
   ``--offset-and-scale-inputs``. Each run's launch counts start at 0 and
   must show its kernels (run (c) exactly 1 cubic and 2 nearest warps);
   its layers and coverage metadata are held against the numpy oracle and
   the host's counts, (a)'s ocean against the
   host's distance-transform ocean mask, and (c)'s DEM and SHAD against
   the host float64 warp and shadow;
5. campaign: ``python -m proteus_tpu_torch.cli.dswx_campaign``'s ``main``
   on ``cuda`` over three jobs (tile A, a second tile B, a copy of A) at
   full size with DEM, CGLS, WorldCover, browse and
   ``--tiles-per-device 2`` (one batch of two tiles, one padded), three
   times: (d) int16 'mask'; (e) ``--scaled`` (device scale on); (f)
   'cover' with a shoreline on run (a)'s Fmask. Each run's launch counts
   start at 0 and must show its slices; tile A's files are held against
   phase 4's run of the same mode, tile B's science layers against the
   numpy oracle, the campaign totals against the host's counts; each
   campaign's peak device memory beside its reading with the eager warp. Phase 5c: (g) and (h), campaigns (f) and (e) again
   through ``CampaignRunner`` with each tile's rows cut over a 1 x 4 mesh
   of card 0 (``spatial_shards=4``, K6 spatial): their product files
   byte-identical to (f)'s and (e)'s but for the processing time, their
   totals equal to the reference's spatial rule computed on the host.
   Then the campaign step alone at 1, 2, 4 and 8 tiles a device;
6. multi-card (only when two or more cards are visible; skipped on one):
   the campaign CLI over every card against the same campaign on card 0
   alone, six jobs of 1024^2 in the modes of phase 5, file by file, with
   each card's launches and the oracle checked; then ``--spatial-shards
   2`` and, on four cards, ``4`` against card 0 alone, with each card's
   peak memory.

7. profile: ``proteus_tpu_torch.tools.kernel_profile``'s ``main`` at full
   size (the null kernel's caller; its launch count starts at 0): every
   variant's ms/tile, effective GB/s and the attribution; the bench twin
   once at a small K; then the default single-tile CLI run again with
   ``PROTEUS_TPU_TRACE_DIR`` set: the device's busy and idle share over
   the device-chain stage, the top device operations, and the traced
   run's layers against run (c)'s;
8. otsu and raw Sentinel-2: the otsu hillshade at full size (with the DEM
   margin) on four terrains against the host float64 oracle, bytes and
   otsu masks, with the uncertainty band's population; a full-size
   single-tile CLI run with ``shadow_masking_algorithm: otsu``, SHAD
   against the host otsu chain on the host-warped DEM; one 10 m band of
   3 x 3660 px a side ingested on the card against the numpy 3 x 3 mean;
9. tools: the campaign instruments of ``proteus_tpu_torch/tools`` through
   their ``main`` on card 0 at full size: ``bench_cold_grid`` over 3 tiles
   on 3 distinct grids and 3 revisits of one grid (the ancillary cache
   misses 3 and 1 times a kind; tile 0 of each run against the numpy
   oracle), ``soak_back_to_back`` (the int16 and the scaled soak of 6
   tiles: an injected reader fault, a SIGKILL after 2 tiles done, the
   manifest resume; each must pass with its kill mid-campaign),
   ``host_budget`` (1 pass) and ``bench_batch`` (B = 1, 2, 4, int16 and
   scaled). A line a tool with the card's name and power limit.

``python3 chip_smoke.py --multi-gpu`` runs phases 1, 2 and 6 alone.

The last lines are the card's name and power limit, a JSON line with each
kernel's launches, error, times and bound, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository, it exits nonzero and prints no result.
"""

import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

SIZE = 3660
DEVICE = 'cuda'
# phase 3e's geometries past a warp block's whole-row staging and past
# exact float32 row numbers: a grid of WIDE_SIDE px at spacing 8 (lattice
# rows of 7,502 columns, in column chunks) and outputs of 2 x LONG_SIDE px
# (row and column numbers past 2^24)
WIDE_SIDE = 60000
LONG_SIDE = 2 ** 24 + 4099
REPO = os.path.dirname(os.path.abspath(__file__))
# the card's memory rate and its float32 rate outside the tensor cores
# (NVIDIA's H100 SXM data sheet), for each kernel's least time
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def say(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device(torch):
    say('== phase 1: device')
    say(f'nvidia-smi: {nvidia_smi_line()}')
    from proteus_tpu_torch.ops.build import nvcc_path
    nvcc = subprocess.run([nvcc_path(), '--version'], capture_output=True,
                          text=True, check=True, timeout=60)
    say(f'torch {torch.__version__}, CUDA runtime {torch.version.cuda}, '
        f'nvcc: {nvcc.stdout.strip().splitlines()[-1]}')
    say(f'device 0: {torch.cuda.get_device_name(0)}, '
        f'count {torch.cuda.device_count()}')
    present = {}
    for mod in ('yaml', 'PIL'):
        try:
            __import__(mod)
            present[mod] = True
        except ImportError:
            present[mod] = False
    say(f'host packages present: {present}')


def phase_build():
    say('== phase 2: build')
    from proteus_tpu_torch import native
    from proteus_tpu_torch.native import build as native_build
    from proteus_tpu_torch.ops.build import build
    t0 = time.perf_counter()
    native_build.build(verbose=False)
    say(f'native codec: {native_build.lib_path()} built from '
        f'proteus_tpu_torch/native/tiffturbo.cpp in '
        f'{time.perf_counter() - t0:.2f} s, linked '
        f'{native_build.linked()}; codec in use: {native.codec()}')
    if not native.codec().startswith('native'):
        raise AssertionError('the native codec did not load')
    # one nvcc a source, all started together
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    names = ('wtr_kernel', 'null_kernel', 'warp_kernel')
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build, names))
    for name, built in zip(names, builds):
        say(f'{name}: {built.path}; nvcc {built.seconds:.2f} s, both built '
            f'and loaded {time.perf_counter() - t0:.2f} s after the start')
        for line in built.log.splitlines():
            if 'ptxas' in line:
                say(f'    {line.strip()}')


def _random_inputs(torch, rng, device):
    """3660^2 bands with int16 extremes (the wrap is load-bearing) and
    random fmask / invalid / ancillary planes, on the card."""
    import numpy as np
    shape = (SIZE, SIZE)
    bands = []
    for _ in range(6):
        b = rng.integers(-2000, 18000, shape)
        extreme = rng.random(shape) < 0.1
        b = np.where(extreme, rng.integers(-32768, 32768, shape), b)
        bands.append(b.astype(np.int16))
    planes = dict(
        fmask=rng.integers(0, 256, shape).astype(np.uint8),
        invalid=rng.random(shape) < 0.05,
        ocean=(rng.random(shape) < 0.9).astype(np.uint8),
        shadow=(rng.random(shape) < 0.8).astype(np.uint8),
        landcover=rng.choice(np.array([0, 21, 100, 121, 200, 201, 255],
                                      np.uint8), shape))

    def dev(a):
        return torch.from_numpy(a).to(device)
    return [dev(b) for b in bands], {k: dev(v) for k, v in planes.items()}


RATIO_TESTS = (('wigt', 'gt'), ('pswt_1_mndwi', 'gt'), ('pswt_2_mndwi', 'gt'),
               ('pswt_1_ndvi', 'lt'))


def scaled_bands(rng, shape, thresholds):
    """float32 bands as the scaled ingest makes them (0.0001 * float32 of
    the clipped int16), 1% of pixels zero in every band (0/0 quotients,
    NaN), and in a quarter
    of the pixels one operand of a ratio test pushed within +-2 float32
    ULPs of the rounding boundary of its threshold (after
    tests/test_pallas_kernel.py:63-76): green for wigt and the two
    pswt_*_mndwi, nir for pswt_1_ndvi. Returns blue, green, red, nir,
    swir1, swir2."""
    import numpy as np
    bands = [np.float32(1e-4) * rng.integers(1, 18000, shape).astype(
        np.float32) for _ in range(6)]
    zero = rng.random(shape) < 0.01
    for b in bands:
        b[zero] = 0
    blue, green, red, nir, swir1, swir2 = bands
    which = rng.integers(0, 16, shape)
    for k, (name, op) in enumerate(RATIO_TESTS):
        t32 = np.float32(getattr(thresholds, name))
        toward = np.float32(np.inf if op == 'gt' else -np.inf)
        m = (np.float64(t32) + np.float64(np.nextafter(t32, toward))) * 0.5
        # (a - c) / (a + c) == m  <=>  a = c * (1 + m) / (1 - m)
        a, c = (nir, red) if name == 'pswt_1_ndvi' else (green, swir1)
        sel = (which == k) & (c != 0)  # c == 0 would push a to subnormals
        pushed = (c[sel].astype(np.float64) * (1 + m) / (1 - m)).astype(
            np.float32)
        steps = rng.integers(-2, 3, pushed.shape)
        for _ in range(2):
            pushed = np.where(steps > 0, np.nextafter(pushed, np.float32(
                np.inf)), pushed)
            pushed = np.where(steps < 0, np.nextafter(pushed, np.float32(
                -np.inf)), pushed)
            steps = steps - np.sign(steps)
        a[sel] = pushed
    return bands


def _ordered(x):
    """float32 values as integers in the order of the floats (adjacent
    floats differ by 1)."""
    import numpy as np
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def boundary_pairs(threshold, scales, offsets, a, c):
    """Raw int16 pairs (A, C) of bands a and c (indices into blue..swir2)
    whose scaled ratio (a - c) / (a + c), with a = scale * (float32(A) -
    offset) in float32 as the device-scale kernel computes it, lands
    within 2 float32 ULPs of the threshold (on either side). Returns an
    (n, 2) int16 array."""
    import numpy as np
    t32 = np.float32(threshold)
    cc = np.arange(1, 32768, dtype=np.int64)
    cs = scales[c] * (cc.astype(np.float32) - offsets[c])
    ratio = (1 + np.float64(t32)) / (1 - np.float64(t32))
    found = []
    for step in (-1, 0, 1):
        aa = np.rint((cs.astype(np.float64) * ratio) / np.float64(scales[a])
                     + np.float64(offsets[a])).astype(np.int64) + step
        ok = (aa >= 1) & (aa <= 32767)
        av = scales[a] * (aa[ok].astype(np.float32) - offsets[a])
        q = (av - cs[ok]) / (av + cs[ok])
        near = np.abs(_ordered(q) - _ordered(t32)) <= 2
        found.append(np.stack([aa[ok][near], cc[ok][near]], axis=1))
    pairs = np.concatenate(found).astype(np.int16)
    if len(pairs) < 10:
        raise AssertionError(f'only {len(pairs)} boundary pairs for '
                             f'{threshold}')
    return pairs


def raw_scaled_tile(rng, shape, thresholds, scales, offsets):
    """Raw int16 bands for the device-scale kernel (K4) with this tile's
    scales and offsets: 1% of pixels 0 in every band, and in a quarter of
    the pixels the two bands of one ratio test replaced by a raw pair whose
    scaled ratio lies within 2 ULPs of its threshold (green and swir1 for
    wigt and the two pswt_*_mndwi, nir and red for pswt_1_ndvi)."""
    import numpy as np
    raw = [rng.integers(1, 18000, shape).astype(np.int16) for _ in range(6)]
    zero = rng.random(shape) < 0.01
    for r in raw:
        r[zero] = 0
    which = rng.integers(0, 16, shape)
    for k, (name, _) in enumerate(RATIO_TESTS):
        a, c = (3, 2) if name == 'pswt_1_ndvi' else (1, 4)
        pairs = boundary_pairs(getattr(thresholds, name), scales, offsets,
                               a, c)
        sel = (which == k) & ~zero
        pick = pairs[rng.integers(0, len(pairs), int(sel.sum()))]
        raw[a][sel] = pick[:, 0]
        raw[c][sel] = pick[:, 1]
    return raw


# the band (its index in blue .. swir2) that each scalar threshold tests
BAND_TESTS = (('pswt_1_swir1', 4), ('pswt_1_nir', 3), ('pswt_2_blue', 0),
              ('pswt_2_swir1', 4), ('pswt_2_swir2', 5), ('pswt_2_nir', 3),
              ('lcmask_nir', 3))


def boundary_int16_bands(rng, shape, thresholds):
    """int16 bands pushed onto the decision boundaries of ``thresholds``
    (after tests/test_torch_inexact.py::boundary_bands): in a tenth of the
    pixels each, the operands of one ratio test with num = floor(t * den)
    - 1 .. + 2 (denominators that are multiples of 30, so that quotients of
    small rationals are exact and the division's rounding decides), zero
    denominators (x/0 and 0/0), one band on floor(t) - 1 .. floor(t) + 2 of
    its scalar threshold, and swir2 chosen so that 4 * AWEsh lies on
    floor(4 t) - 1 .. floor(4 t) + 2; the rest random with int16 extremes.
    Returns blue, green, red, nir, swir1, swir2."""
    import numpy as np
    bands = []
    for _ in range(6):
        b = rng.integers(-2000, 18000, shape)
        extreme = rng.random(shape) < 0.1
        bands.append(np.where(extreme, rng.integers(-32768, 32768, shape),
                              b))
    kind = rng.integers(0, 10, shape)
    jitter = rng.integers(-1, 3, shape)
    den = 30 * rng.integers(1, 400, shape)
    for k, (name, _) in enumerate(RATIO_TESTS):
        t = np.float64(getattr(thresholds, name))
        if not np.isfinite(t) or abs(t) > 1:
            continue
        # a + c = den and a - c = num (or num + 1 where the parities differ)
        num = np.floor(t * den).astype(np.int64) + jitter
        num = num + ((den + num) & 1)
        a, c = (3, 2) if name == 'pswt_1_ndvi' else (1, 4)
        sel = kind == k
        bands[a] = np.where(sel, (den + num) // 2, bands[a])
        bands[c] = np.where(sel, (den - num) // 2, bands[c])
    sel = kind == 4
    bands[4] = np.where(sel, -bands[1], bands[4])
    bands[2] = np.where(sel, -bands[3], bands[2])
    bands[1] = np.where(sel & (jitter == 0), 0, bands[1])
    bands[4] = np.where(sel & (jitter == 0), 0, bands[4])
    which = rng.integers(0, len(BAND_TESTS), shape)
    for k, (name, band) in enumerate(BAND_TESTS):
        t = np.float64(getattr(thresholds, name))
        if np.isfinite(t):
            sel = (kind == 5) & (which == k)
            bands[band] = np.where(sel, int(np.floor(t)) + jitter,
                                   bands[band])
    bands = [np.clip(b, -32768, 32767).astype(np.int16) for b in bands]
    t = np.float64(thresholds.awgt)
    if np.isfinite(t):
        b, g = (bands[k].astype(np.int64) for k in (0, 1))
        mbsrn = (bands[3] + bands[4]).astype(np.int64)  # wraps in int16
        s2 = 4 * b + 10 * g - 6 * mbsrn - (int(np.floor(4 * t)) + jitter)
        sel = ((kind == 6) | (kind == 7)) & (np.abs(s2) < 32768)
        bands[5] = np.where(sel, s2, bands[5]).astype(np.int16)
    return bands


def structured_cover_fmask(shape):
    """An fmask for 'cover' mode (after tests/test_pallas_kernel.py:99-123):
    adjacent-to-cloud nearly everywhere, snow stripes and blobs that cross
    the kernel's 32 px tile seams and touch the image edges, cloud and
    shadow blocks."""
    import numpy as np
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    fmask = np.where((xx // 50 + yy // 70) % 5 != 0, 4, 0).astype(np.uint8)
    fmask[(yy % 97 >= 30) & (yy % 97 < 34)] |= 16         # row stripes
    fmask[(xx % 113 >= 62) & (xx % 113 < 65)] |= 16       # column stripes
    fmask[(yy % 150 >= 95) & (yy % 150 < 97)
          & (xx % 150 >= 40) & (xx % 150 < 90)] |= 16     # seam blobs
    fmask[:2, -7:] |= 16                                  # corner blob
    fmask[(yy % 200 >= 60) & (yy % 200 < 70)
          & (xx % 200 >= 60) & (xx % 200 < 70)] |= 2      # cloud
    fmask[(yy % 180 >= 120) & (yy % 180 < 126)
          & (xx % 170 >= 20) & (xx % 170 < 30)] |= 8      # cloud shadow
    return fmask


def cover_tile_fmask(fmask):
    """The synthetic tile's Fmask (tests/synthetic.py) changed so that
    'cover' mode has work: adjacent-to-cloud pixels over the west half of
    the water disk and the land around it, crossed by snow stripes. The
    stock Fmask keeps its snow rows and its adjacency ring apart."""
    size = fmask.shape[0]
    out = fmask.copy()

    def px(f):
        return int(round(f * size))
    out[px(0.40):px(0.80), px(0.05):px(0.45)] |= 4
    out[px(0.50):px(0.50) + 2, px(0.05):px(0.45)] |= 16
    out[px(0.40):px(0.80), px(0.20):px(0.20) + 2] |= 16
    return out


def _time_ms(torch, fn, inputs, repeats, cycles=4):
    """Median over ``repeats`` of the per-call device time: CUDA events
    around a batch that cycles ``cycles`` times through the input sets
    (each larger than the 50 MB L2), divided by the batch size. The card
    spins for about 10 ms before the first event while the host queues the
    batch: a wrapper's host time a call (allocating nine planes, the
    checks) is as long as a kernel of 0.1 ms, and without the hold the
    events would time the host."""
    fn(*inputs[0])  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(cycles):
            for args in inputs:
                fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (cycles * len(inputs)))
    return statistics.median(times)


def _copy_bandwidth(torch, nbytes=2 * 2**30):
    """Device-to-device copy rate (bytes read + written per second) of a
    2 GiB buffer: the card's sustainable HBM bandwidth as a yardstick."""
    src = torch.empty(nbytes, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    ms = _time_ms(torch, lambda: dst.copy_(src), [()], 5, cycles=10)
    return 2 * nbytes / (ms * 1e-3)


def _compare(torch, got, want, what):
    """Max |kernel - plain| over the layers; raises unless 0 everywhere."""
    if sorted(got) != sorted(want):
        raise AssertionError(f'layer sets differ: {sorted(got)} vs '
                             f'{sorted(want)} ({what})')
    max_err = 0
    for name in want:
        a = got[name].to(torch.int32)
        b = want[name].to(torch.int32)
        err = int((a - b).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(a, b):
            raise AssertionError(f'{name} differs (max |err| {err}) with '
                                 f'{what}')
    return max_err


def phase_kernel_vs_plain(torch):
    import itertools
    import numpy as np
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.ops import wtr_kernel

    say('== phase 3: kernels vs plain chain on the card, '
        f'{SIZE}x{SIZE}')
    device = torch.device(DEVICE)
    rng = np.random.default_rng(20261016)
    thresholds = DswxChainConfig().thresholds

    def dev(a):
        return torch.from_numpy(a).to(device)
    bands_i16, planes = _random_inputs(torch, rng, device)
    bands = {'int16': bands_i16, 'float32': [
        dev(b) for b in scaled_bands(rng, (SIZE, SIZE), thresholds)]}
    fmasks = {'random': planes['fmask'],
              'structured': dev(structured_cover_fmask((SIZE, SIZE)))}
    errors = dict.fromkeys(wtr_kernel.LAUNCHES, 0)
    n_cases = n_runs = 0
    for dtype, mode, (with_ocean, with_shadow, with_lc), browse in \
            itertools.product(('int16', 'float32'), wtr_kernel.MODES,
                              itertools.product((False, True), repeat=3),
                              (False, True)):
        # vary the aerosol and browse options with the ancillary flags
        cfg = DswxChainConfig(
            mask_adjacent_to_cloud_mode=mode,
            apply_aerosol_class_remapping=not (with_ocean and mode == 'ignore'),
            exclude_psw_aggressive_in_browse=not with_ocean,
            not_water_in_browse='nodata' if with_shadow else 'white',
            cloud_in_browse='nodata' if with_lc else 'gray',
            snow_in_browse='nodata' if mode == 'ignore' else 'cyan')
        kw = dict(ocean=planes['ocean'] if with_ocean else None,
                  shadow=planes['shadow'] if with_shadow else None,
                  landcover=planes['landcover'] if with_lc else None,
                  compute_browse=browse)
        for fmask_kind in (('random', 'structured') if mode == 'cover'
                           else ('random',)):
            args = (*bands[dtype], fmasks[fmask_kind], planes['invalid'],
                    cfg)
            got = wtr_kernel.wtr_layers(*args, **kw)
            want = wtr_kernel.wtr_layers_plain(*args, **kw)
            torch.cuda.synchronize()
            err = _compare(torch, got, want, (
                f'bands={dtype} mode={mode} fmask={fmask_kind} ocean='
                f'{with_ocean} shadow={with_shadow} landcover={with_lc} '
                f'browse={browse}'))
            for name in wtr_kernel.kernel_slices(dtype == 'float32', mode):
                errors[name] = max(errors[name], err)
            n_runs += 1
        n_cases += 1
    say(f'kernels == plain chain, bit for bit, and their coverage counts '
        f'== coverage_counts, in {n_cases} combinations '
        f'(int16/float32 bands x mask/ignore/cover x ancillaries x browse;'
        f' {n_runs} runs, the cover ones on a random and a structured '
        f'fmask; boundary-pushed float32 bands); max |err| {errors}')

    _odd_shapes_vs_plain(torch, bands, planes, fmasks)
    _inexact_vs_plain(torch, rng, planes, fmasks)

    # timing at the main path's flags, over varied inputs
    inputs = {'int16': [(*bands_i16, planes['fmask'], planes['invalid'])],
              'float32': [(*bands['float32'], planes['fmask'],
                           planes['invalid'])]}
    for _ in range(3):
        b2, p2 = _random_inputs(torch, rng, device)
        inputs['int16'].append((*b2, p2['fmask'], p2['invalid']))
        inputs['float32'].append(
            (*[dev(b) for b in scaled_bands(rng, (SIZE, SIZE), thresholds)],
             p2['fmask'], p2['invalid']))
        del b2, p2
    configs = {'mask': DswxChainConfig(),
               'cover': DswxChainConfig(mask_adjacent_to_cloud_mode='cover')}
    main_kw = dict(shadow=planes['shadow'], landcover=planes['landcover'])
    # slice: (bands, mode)
    cells = {'wtr_k1': ('int16', 'mask'), 'wtr_k3': ('float32', 'mask'),
             'wtr_k2': ('int16', 'cover')}
    copy_bw = _copy_bandwidth(torch)
    stats = {}
    for name, (dtype, mode) in cells.items():
        cfg = configs[mode]
        bytes_px = FUNCTION_BYTES_PER_PX[name]

        def kernel(*a):
            return wtr_kernel.wtr_layers(*a, cfg, **main_kw)

        def plain(*a):
            return wtr_kernel.wtr_layers_plain(*a, cfg, **main_kw)
        plain_ms = [_time_ms(torch, plain, inputs[dtype], 3)]
        kernel_ms = [_time_ms(torch, kernel, inputs[dtype], 10)]
        kernel_ms.append(_time_ms(torch, kernel, inputs[dtype], 10))
        plain_ms.append(_time_ms(torch, plain, inputs[dtype], 3))
        ms, pms = statistics.median(kernel_ms), statistics.median(plain_ms)
        tile_bytes = bytes_px * SIZE * SIZE
        say(f'{name} ({dtype}, {mode!r}; shadow + landcover + browse): '
            f'kernel {ms:.4f} ms/tile (runs {kernel_ms}), plain chain '
            f'{pms:.4f} ms/tile (runs {plain_ms}); {bytes_px} B/px = '
            f'{tile_bytes / 1e6:.1f} MB/tile = '
            f'{tile_bytes / (ms * 1e-3) / 1e9:.1f} GB/s, '
            f'{tile_bytes / (ms * 1e-3) / copy_bw:.1%} of the device copy')
        stats[name] = {'max_abs_err': errors[name], 'ms': ms,
                       'plain_ms': pms, **_bound(name, tile_bytes)}

    # K1 with a ratio threshold that is no exact rational: the float64
    # ratio tests
    from proteus_tpu_torch.core.thresholds import HlsThresholds
    cfg_f64 = DswxChainConfig(thresholds=HlsThresholds(**INEXACT_THRESHOLDS))
    f64_ms = [_time_ms(torch, lambda *a: wtr_kernel.wtr_layers(
        *a, cfg_f64, **main_kw), inputs['int16'], 10) for _ in range(2)]
    say(f"wtr_k1 with inexact thresholds (int16, 'mask', float64 ratio "
        f'tests): {statistics.median(f64_ms):.4f} ms/tile (runs {f64_ms}) '
        f'against {stats["wtr_k1"]["ms"]:.4f} with exact rationals')

    # K2's second pass alone, on the state bytes of its first
    out, state, flags, _, _ = wtr_kernel.pixel_pass(
        *[t.unsqueeze(0) for t in inputs['int16'][0]], configs['cover'],
        **{k: v.unsqueeze(0) for k, v in main_kw.items()}, batched=False)
    pass_b = [_time_ms(torch, lambda: wtr_kernel.launch_k2(state, out, flags),
                       [()], 10, cycles=16) for _ in range(2)]
    say(f'wtr_k2 pass B alone (state + WTR-2 in, 5 layers out): '
        f'{statistics.median(pass_b):.4f} ms/tile (runs {pass_b}); '
        f'device copy {copy_bw / 1e9:.1f} GB/s')
    return stats, inputs, planes, fmasks, copy_bw


def _launched(torch, *planes, config, scales=None, offsets=None, ocean=None,
              shadow=None, landcover=None, compute_browse=True,
              minimal=False, window=None, ocean_in_valid=True):
    """``wtr_layers`` (2-D planes: the bands, fmask, invalid) or
    ``wtr_layers_batched`` (stacks) on the card through the wrappers' own
    launch: the layers and coverage counts, and the pixels a thread of the
    per-pixel launch took (8, 4 in a window, or 1)."""
    from proteus_tpu_torch.ops import wtr_kernel
    single = planes[0].dim() == 2

    def lift(t):
        return t.unsqueeze(0) if single and t is not None else t
    out, vectorized = wtr_kernel._launch(
        [lift(b) for b in planes[:6]], lift(planes[6]), lift(planes[7]),
        config, scales, offsets, lift(ocean), lift(shadow), lift(landcover),
        compute_browse, minimal, batched=not single, window=window,
        ocean_in_valid=ocean_in_valid)
    if single:
        out = {name: t[0] for name, t in out.items()}
    return out, vectorized


def _check_window_body(what, ran, width, inputs, outputs):
    """Raises unless a windowed launch took the body that
    ``wtr_kernel.window_body`` chooses for its planes (the inputs and the
    layers; the 'cover' state is an allocation of its own, aligned as the
    layers are)."""
    from proteus_tpu_torch.ops import wtr_kernel
    planes = [t for t in (*inputs, *outputs.values())
              if t is not None and t.dim() == 3]
    want = wtr_kernel.window_body(
        width, [(t.data_ptr(), t.element_size()) for t in planes])
    if ran != want:
        raise AssertionError(f'{what}: the windowed launch took the body of '
                             f'{ran} px a thread, window_body chose {want}')


def _shifted(torch, t):
    """The same values, one element into a fresh buffer (no vector
    alignment)."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _odd_shapes_vs_plain(torch, bands, planes, fmasks):
    """The per-pixel pass off its vector path and K2 off its tile grid,
    each against the plain twin, bit for bit: every plane starting one
    element into its buffer (no pointer aligned to its vector: the
    one-pixel body takes everything), an aligned 1001 x 1003 crop (n % 8 =
    3: the vector body and a one-pixel tail; neither side a multiple of
    K2's 94 px tile), a [2, 1001, 1003] stack with per-tile scales (H * W is
    no multiple of 8: a group of 8 would straddle two tiles, so the
    one-pixel body again), and 'cover' windows whose first row is no
    multiple of the tile (W = 1003 is no multiple of 4: the windowed
    one-pixel body). Each case checks which body the launcher took."""
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.ops import wtr_kernel

    def shifted(t):
        return _shifted(torch, t)

    # two odd sides (1001 x 1003 at the full size): n % 8 is odd
    ch = (min(1001, SIZE) - 1) | 1
    cw = ch + 2 if ch + 2 <= SIZE else ch - 2

    def crop(t):
        return t[:ch, :cw].contiguous()

    n_cases = err = 0

    def check(what, body, launched, want):
        nonlocal n_cases, err
        got, ran = launched
        torch.cuda.synchronize()
        err = max(err, _compare(torch, got, want, what))
        if ran != body:
            raise AssertionError(f'{what}: the body of {ran} px a thread '
                                 f'ran, expected {body}')
        n_cases += 1

    for dtype, mode, browse in (('int16', 'mask', True),
                                ('float32', 'ignore', False),
                                ('int16', 'cover', True),
                                ('float32', 'cover', False)):
        cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
        fmask = fmasks['structured' if mode == 'cover' else 'random']
        args = (*bands[dtype], fmask, planes['invalid'])
        kw = {k: planes[k] for k in ('ocean', 'shadow', 'landcover')}
        for what, move, body in (
                ('aligned', lambda t: t, 8),
                ('every plane 1 element into its buffer', shifted, 1),
                (f'{ch} x {cw} (n % 8 = {ch * cw % 8})', crop, 8)):
            a = [move(t) for t in args]
            k = {name: move(t) for name, t in kw.items()}
            check(f'bands={dtype} mode={mode}, {what}', body,
                  _launched(torch, *a, config=cfg, **k,
                            compute_browse=browse),
                  wtr_kernel.wtr_layers_plain(*a, cfg, **k,
                                              compute_browse=browse))
    # K4 on a stack whose tiles are no multiple of 8 px, K5's packed planes
    scales = torch.tensor([[1e-4] * 6, [2e-4] * 6], device=DEVICE)
    offsets = torch.tensor([[0.0] * 6, [-0.1] * 6], device=DEVICE)
    for mode in ('mask', 'cover'):
        cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
        a = [torch.stack([crop(t), crop(torch.roll(t, 5, 0))])
             for t in (*bands['int16'], fmasks['structured'],
                       planes['invalid'])]
        kw = dict(scales=scales, offsets=offsets, minimal=True,
                  landcover=torch.stack([crop(planes['landcover'])] * 2))
        check(f'device scale, B=2 x {ch} x {cw}, mode={mode}', 1,
              _launched(torch, *a, config=cfg, **kw),
              wtr_kernel.wtr_layers_batched_plain(*a, cfg, **kw))
        # the same stack without the scales: the vector body, whose groups
        # of 8 may cross from tile 0 into tile 1
        del kw['scales'], kw['offsets']
        check(f'int16, B=2 x {ch} x {cw}, mode={mode}', 8,
              _launched(torch, *a, config=cfg, **kw),
              wtr_kernel.wtr_layers_batched_plain(*a, cfg, **kw))
    # 'cover' windows off the tile grid (the windowed one-pixel body, W %
    # 4 = 3, but for the window of every row, which is the unwindowed
    # launch)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode='cover')
    a = [torch.stack([crop(t)]) for t in (*bands['int16'],
                                          fmasks['structured'],
                                          planes['invalid'])]
    for window in ((17, 500), (123, 94), (95, ch - 95), (0, ch),
                   (ch - 1, 1)):
        for minimal in (False, True):
            kw = dict(window=window, minimal=minimal)
            check(f"int16 'cover' window {window} of {ch} rows, "
                  f'minimal={minimal}', 8 if window == (0, ch) else 1,
                  _launched(torch, *a, config=cfg, **kw),
                  wtr_kernel.wtr_layers_batched_plain(*a, cfg, **kw))
    say(f'off the vector path and off the tile grid: {n_cases} cases == '
        f'plain twin, bit for bit (unaligned planes and per-tile scales on '
        f'tiles of {ch} x {cw} through the one-pixel body, n % 8 = '
        f'{ch * cw % 8} tails, '
        f"'cover' at sizes and windows that are no multiple of the 94 px "
        f'tile); max |err| {err}')


# thresholds with no exact rational within the kernels' int32 bounds
# (core/thresholds.py), one in every field
INEXACT_THRESHOLDS = dict(
    wigt=0.12345678, awgt=12.3456789, pswt_1_mndwi=-0.440000001,
    pswt_1_nir=1500.314159, pswt_1_swir1=900.00001234,
    pswt_1_ndvi=0.700000001, pswt_2_mndwi=-0.500000001,
    pswt_2_blue=1000.0000014, pswt_2_nir=2500.000017,
    pswt_2_swir1=2999.999999, pswt_2_swir2=1000.1234567,
    lcmask_nir=1200.3000001)


def _inexact_threshold_sets():
    """name -> (thresholds, whether a ratio threshold is inexact: the
    float64 ratio tests)."""
    import math
    inf = math.inf
    return {
        'every field inexact': (INEXACT_THRESHOLDS, True),
        # the float64 next to an exact rational: a quotient that is that
        # rational lies one ULP from the threshold
        'one ULP from a rational': (dict(
            wigt=math.nextafter(1 / 3, inf),
            awgt=math.nextafter(0.25, -inf),
            pswt_1_mndwi=math.nextafter(-1 / 3, -inf),
            pswt_1_nir=math.nextafter(1500.0, inf),
            pswt_1_swir1=math.nextafter(900.0, -inf),
            pswt_1_ndvi=math.nextafter(2 / 3, -inf),
            pswt_2_mndwi=math.nextafter(-0.5, inf),
            pswt_2_blue=math.nextafter(1000.0, inf),
            pswt_2_nir=math.nextafter(2500.0, -inf),
            pswt_2_swir1=math.nextafter(3000.0, inf),
            pswt_2_swir2=math.nextafter(1000.0, -inf),
            lcmask_nir=math.nextafter(1200.0, inf)), True),
        # one inexact ratio beside exact ones, and tests that never or
        # always hold
        'one ratio, nan and infinities': (dict(
            pswt_1_ndvi=0.700000001, awgt=inf, pswt_1_nir=-inf,
            pswt_2_blue=inf, lcmask_nir=math.nan), True),
        # the integer ratio tests with bounds from float64 thresholds
        'scalars only': (dict(
            awgt=math.e / 10, pswt_1_nir=1500.314159, pswt_1_swir1=900.00001234,
            pswt_2_swir2=1000 + 1 / math.e, lcmask_nir=0.1 + 0.2), False),
    }


def _inexact_vs_plain(torch, rng, planes, fmasks):
    """int16-band thresholds that are no exact rationals, on the card: the
    kernels (the float64 ratio tests of the per-pixel pass in its 8-pixel,
    one-pixel and windowed 4-pixel bodies; the integer bounds from float64
    thresholds) against the plain chain, bit for bit, on bands pushed onto
    the decision boundaries; on the upper half of the tile's planes (the
    host makes a set of bands for each set of thresholds)."""
    from proteus_tpu_torch.core.thresholds import (ExactThresholds,
                                                   HlsThresholds)
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.ops import wtr_kernel

    n_cases = err = 0
    height = SIZE // 2
    rows = (height // 4 + 3, height // 2)
    planes = {name: t[:height] for name, t in planes.items()}
    fmasks = {name: t[:height] for name, t in fmasks.items()}
    for what, (values, f64) in _inexact_threshold_sets().items():
        thresholds = HlsThresholds(**values)
        exact = ExactThresholds.from_thresholds(thresholds)
        if any(getattr(exact, name)[2] for name in values):
            raise AssertionError(f'{what}: an exact rational among {exact}')
        params, _, _ = wtr_kernel.kernel_params(
            DswxChainConfig(thresholds=thresholds))
        if bool(params.ratio_f64) is not f64:
            raise AssertionError(f'{what}: ratio_f64 {params.ratio_f64}')
        bands = [torch.from_numpy(b).to(DEVICE) for b in
                 boundary_int16_bands(rng, (height, SIZE), thresholds)]
        kw = {k: planes[k] for k in ('ocean', 'shadow', 'landcover')}
        for mode in wtr_kernel.MODES:
            cfg = DswxChainConfig(thresholds=thresholds,
                                  mask_adjacent_to_cloud_mode=mode)
            fmask = fmasks['structured' if mode == 'cover' else 'random']
            args = (*bands, fmask, planes['invalid'])
            want = wtr_kernel.wtr_layers_plain(*args, cfg, **kw)
            for moved, move, body in (
                    ('aligned', lambda t: t, 8),
                    ('1 element into its buffer',
                     lambda t: _shifted(torch, t), 1)):
                got, ran = _launched(
                    torch, *[move(t) for t in args], config=cfg,
                    **{name: move(t) for name, t in kw.items()})
                torch.cuda.synchronize()
                label = f'{what}, mode={mode}, {moved}'
                err = max(err, _compare(torch, got, want, label))
                if ran != body:
                    raise AssertionError(f'{label}: the body of {ran} px a '
                                         f'thread ran, expected {body}')
                n_cases += 1
            if mode == 'ignore':
                continue
            # the windowed 4-pixel body, full and packed outputs
            stack = [t.unsqueeze(0) for t in args]
            for minimal in (False, True):
                wkw = dict(window=rows, minimal=minimal,
                           landcover=planes['landcover'].unsqueeze(0))
                got, ran = _launched(torch, *stack, config=cfg, **wkw)
                label = f'{what}, mode={mode}, window, minimal={minimal}'
                err = max(err, _compare(
                    torch, got, wtr_kernel.wtr_layers_batched_plain(
                        *stack, cfg, **wkw), label))
                _check_window_body(label, ran, SIZE,
                                   stack + [wkw['landcover']], got)
                n_cases += 1
        del bands
    say(f'inexact int16-band thresholds: {n_cases} cases == plain chain, '
        f'bit for bit ({len(_inexact_threshold_sets())} sets of thresholds '
        f'x mask/ignore/cover x the 8-pixel, one-pixel and windowed 4-pixel '
        f'bodies; float64 ratio tests and integer bounds from float64 '
        f'thresholds; '
        f'boundary-pushed int16 bands of {height} x {SIZE}); max |err| '
        f'{err}')


# bytes a pixel each slice's function must move at the main path's flags
# (shadow, landcover, browse; minimal outputs for K4-K6): its inputs read
# once and its outputs written once, as in csrc/wtr_kernel.cu (the [B, 3]
# coverage counts are 24 B a tile). 'cover' (K2) reads K1's 16 B (six
# int16 bands, Fmask, invalid, shadow, landcover) and writes its 9 B
# (DIAG's 2, WTR-1, WTR-2, WTR, BWTR, CONF, CLOUD, BROWSE); the state byte
# pass A writes and pass B reads, and pass B's read of WTR-2, are the
# kernel's own 3 B more.
FUNCTION_BYTES_PER_PX = {'wtr_k1': 25, 'wtr_k2': 25, 'wtr_k3': 37,
                         'wtr_k4': 18, 'wtr_k5': 18, 'wtr_k6': 18}
# the null kernel over the profile tool's 8 planes (6 bands, fmask,
# invalid) and its one uint8 plane out: int16 bands, float32 bands
NULL_BYTES_PER_PX = {'int16': 6 * 2 + 1 + 1 + 1, 'float32': 6 * 4 + 1 + 1 + 1}
# operations a pixel each slice's function needs at the main path's flags,
# for the operations side of the bound: counted line by line in
# csrc/wtr_kernel.cu, one for each add, multiply, divide, convert,
# compare, logical operation, shift and select (loads and stores are the
# bytes side); each includes the coverage counts. The function's count,
# not the kernel's: K2's pass B
# recomputes its 17 px halo, 128^2/94^2 = 1.85 times the dilation work, on
# bit-planes, a few word operations a row a step.
_OPS = {
    # diag_tests<int16>: 6 wrapped sums (an add and wrap16's add, and,
    # subtract: 24), AWEsh (3 multiplies, 3 adds: 6), 4 ratio tests (2
    # multiplies, 6 compares, 5 logical: 52), t2 (1), t3 (3), t4's and
    # t5's 6 band tests (a multiply and a compare each) with their 7 ANDs
    # (19), the two NIR tests (3)
    'tests_int16': 24 + 6 + 52 + 1 + 3 + 19 + 3,
    # diag_tests<float>: MNDWI and NDVI (a subtract, an add, a divide
    # each: 6), MBSRV and MBSRN (2), AWEsh (3 multiplies, 3 adds: 6), the
    # 12 compares of t1 ... t5 with their 7 ANDs (19), the two NIR
    # compares (2)
    'tests_float': 6 + 2 + 6 + 19 + 2,
    # K4: scale_band on 6 bands (convert, subtract, multiply: 18), the
    # tile index i / (H*W) and its row (2)
    'cast': 18 + 2,
    # wtr_pixel_kernel from the invalid test to WTR-2 at shadow +
    # landcover: invalid (1), WTR-1 (4 adds, 13 compares and selects, the
    # fill select: 18), preliminary CLOUD (8), the aerosol remap (19), the
    # shadow test (8), the landcover demotions (16); the coverage counts
    # (tile_counts.cuh: not ocean 2, valid 3, cloud and valid 3, their
    # bits into the group's word 3, a share of the popcounts and adds 1)
    'body': 1 + 18 + 8 + 19 + 8 + 16 + 12,
    'snow_bit': 3,                     # fmask bit 4 -> CLOUD + 2
    # the DIAG pseudo-binary (4 multiplies, 4 adds, a select: 9) and
    # finish_pixel with browse (CLOUD 2, WTR 12, BWTR 4, CONF 10, BROWSE
    # 18)
    'full_outputs': 9 + 46,
    # K5: diag6 (4 shifts, 4 ORs, a select: 9), the two class indices
    # (8) and their shifts and OR (3), CLOUD's fill (2), PACKED_A (3) and
    # PACKED_B (3)
    'packed': 9 + 8 + 3 + 2 + 3 + 3,
    'cover_state': 12,                 # the 'cover' state byte
    # K2's pass B: 17 masked cross steps of 7 (three ORs of the four
    # neighbours, the mask's AND and compare, the pixel's test and
    # select), the two seed sets (6), the final snow bit and CLOUD (5)
    'dilations': 17 * 7 + 6 + 5,
}
OPS_PER_PX = {
    'wtr_k1': _OPS['tests_int16'] + _OPS['body'] + _OPS['snow_bit']
    + _OPS['full_outputs'],
    'wtr_k2': _OPS['tests_int16'] + _OPS['body'] + _OPS['cover_state']
    + _OPS['dilations'] + _OPS['full_outputs'],
    'wtr_k3': _OPS['tests_float'] + _OPS['body'] + _OPS['snow_bit']
    + _OPS['full_outputs'],
    # K4-K6 at the flags phase 3b times them with: raw int16 with device
    # scale (K4), int16 (K5, K6), minimal outputs
    'wtr_k4': _OPS['tests_float'] + _OPS['cast'] + _OPS['body']
    + _OPS['snow_bit'] + _OPS['packed'],
    'wtr_k5': _OPS['tests_int16'] + _OPS['body'] + _OPS['snow_bit']
    + _OPS['packed'],
    'wtr_k6': _OPS['tests_int16'] + _OPS['body'] + _OPS['snow_bit']
    + _OPS['packed'],
    # the null kernel on 8 inputs: a convert and an XOR an input, the mask
    'null': 2 * 8 + 1,
}


def _bound(name, tile_bytes):
    """The least time for one tile: the larger of the bytes the function
    must move over the card's memory rate and its operations over the
    card's float32 rate."""
    by_bytes = tile_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = OPS_PER_PX[name] * SIZE * SIZE / PEAK_OPS_PER_S * 1e3
    return {'bound_ms': max(by_bytes, by_ops),
            'bound_by': 'bytes' if by_bytes >= by_ops else 'operations',
            'library_ms': None}


def phase_batched_vs_plain(torch, inputs, planes, fmasks, copy_bw):
    """K4, K5 and K6 through wtr_layers_batched against
    wtr_layers_batched_plain on [B, H, W] stacks on the card, bit for bit;
    then K4+K5+K6 timed at B = 1 and B = 4."""
    import itertools
    import numpy as np
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.ops import wtr_kernel

    say(f'== phase 3b: batched kernels (K4, K5, K6) vs plain, B x {SIZE}'
        f'x{SIZE}')
    device = torch.device(DEVICE)
    rng = np.random.default_rng(20261017)
    thresholds = DswxChainConfig().thresholds
    n_tiles = len(inputs['int16'])
    # per-tile scales and offsets, different in every tile and band
    scales = (np.float32(1e-4) * rng.uniform(0.5, 2.0, (n_tiles, 6))) \
        .astype(np.float32)
    offsets = rng.choice(np.asarray([0.0, -0.1, 0.25], np.float32),
                         (n_tiles, 6))
    raw = [[torch.from_numpy(b).to(device) for b in raw_scaled_tile(
        rng, (SIZE, SIZE), thresholds, scales[k], offsets[k])]
        for k in range(n_tiles)]
    scaled = dict(raw=raw, scales=torch.from_numpy(scales).to(device),
                  offsets=torch.from_numpy(offsets).to(device))

    def stack(kind, b, mode):
        return _stack(torch, inputs, fmasks, scaled, kind, b, mode)

    def plane(name, b):
        return _plane(torch, planes, name, b)

    errors = dict.fromkeys(wtr_kernel.LAUNCHES, 0)
    n_runs = 0
    variants = itertools.cycle(itertools.product((False, True), repeat=4))
    for kind, mode, minimal, b in itertools.product(
            ('int16', 'float32', 'device_scale'), wtr_kernel.MODES,
            (False, True), (1, 3)):
        with_ocean, with_shadow, with_lc, browse = next(variants)
        cfg = DswxChainConfig(
            mask_adjacent_to_cloud_mode=mode,
            apply_aerosol_class_remapping=not (with_ocean
                                               and mode == 'ignore'),
            not_water_in_browse='nodata' if with_shadow else 'white',
            cloud_in_browse='nodata' if with_lc else 'gray')
        bands, fm, inv, kw = stack(kind, b, mode)
        kw.update(ocean=plane('ocean', b) if with_ocean else None,
                  shadow=plane('shadow', b) if with_shadow else None,
                  landcover=plane('landcover', b) if with_lc else None,
                  compute_browse=browse, minimal=minimal)
        got = wtr_kernel.wtr_layers_batched(*bands, fm, inv, cfg, **kw)
        want = wtr_kernel.wtr_layers_batched_plain(*bands, fm, inv, cfg,
                                                   **kw)
        torch.cuda.synchronize()
        err = _compare(torch, got, want, (
            f'bands={kind} mode={mode} minimal={minimal} B={b} ocean='
            f'{with_ocean} shadow={with_shadow} landcover={with_lc} '
            f'browse={browse}'))
        for name in wtr_kernel.kernel_slices(
                kind == 'float32', mode, kind == 'device_scale', minimal,
                batched=True):
            errors[name] = max(errors[name], err)
        n_runs += 1
        del got, want, bands, fm, inv, kw
    say(f'batched kernels == plain, bit for bit, in {n_runs} combinations '
        f'(int16/float32/device-scale bands x mask/ignore/cover x full/'
        f'minimal x B=1/3; ancillaries and browse varied; per-tile scales '
        f'and offsets; raw pairs within 2 ULPs of each ratio threshold); '
        f'max |err| {errors}')

    # K4+K5+K6 at the campaign's default flags (shadow + landcover,
    # minimal outputs), per tile, at B = 1 and B = 4
    cfg = DswxChainConfig()
    tile_bytes = 18 * SIZE * SIZE
    stats = {}
    for kind, b in itertools.product(('int16', 'device_scale'), (1, 4)):
        src = raw if kind == 'device_scale' else \
            [t[:6] for t in inputs[kind]]
        sets = []
        for k in range(0, n_tiles, b):
            idx = list(range(k, k + b))
            args = [torch.stack([src[i][j] for i in idx]) for j in range(6)]
            args += [torch.stack([inputs['int16'][i][6] for i in idx]),
                     torch.stack([inputs['int16'][i][7] for i in idx])]
            kw = dict(shadow=plane('shadow', b), landcover=plane(
                'landcover', b), minimal=True)
            if kind == 'device_scale':
                kw.update(scales=scaled['scales'][idx].contiguous(),
                          offsets=scaled['offsets'][idx].contiguous())
            sets.append((args, kw))

        def kernel(args, kw):
            return wtr_kernel.wtr_layers_batched(*args, cfg, **kw)

        def plain(args, kw):
            return wtr_kernel.wtr_layers_batched_plain(*args, cfg, **kw)
        plain_ms = [_time_ms(torch, plain, sets, 3) / b]
        kernel_ms = [_time_ms(torch, kernel, sets, 10) / b,
                     _time_ms(torch, kernel, sets, 10) / b]
        plain_ms.append(_time_ms(torch, plain, sets, 3) / b)
        ms, pms = statistics.median(kernel_ms), statistics.median(plain_ms)
        slices = wtr_kernel.kernel_slices(False, 'mask',
                                          kind == 'device_scale', True,
                                          batched=True)
        bound_copy = tile_bytes / copy_bw * 1e3
        say(f'{"+".join(slices)} ({kind}, B={b}; shadow + landcover, '
            f'minimal): kernel {ms:.4f} ms/tile (runs {kernel_ms}), plain '
            f'{pms:.4f} ms/tile (runs {plain_ms}); 18 B/px = '
            f'{tile_bytes / 1e6:.1f} MB/tile = '
            f'{tile_bytes / (ms * 1e-3) / 1e9:.1f} GB/s, '
            f'{tile_bytes / (ms * 1e-3) / copy_bw:.1%} of the device copy '
            f'({copy_bw / 1e9:.1f} GB/s); the 18 B/px bound at that copy '
            f'rate is {bound_copy:.4f} ms, {bound_copy / ms:.1%} of the '
            f'kernel time')
        stats[(kind, b)] = (ms, pms)
        del sets
    out = {}
    for name, key in (('wtr_k4', ('device_scale', 4)),
                      ('wtr_k5', ('int16', 1)), ('wtr_k6', ('int16', 4))):
        ms, pms = stats[key]
        out[name] = {'max_abs_err': errors[name], 'ms': ms, 'plain_ms': pms,
                     **_bound(name, tile_bytes)}
    return out, scaled


def _stack(torch, inputs, fmasks, scaled, kind, b, mode):
    """The first b tiles of a kind (int16, float32 or raw int16 with
    device scale) as [b, H, W] inputs of phases 3b and 3c; 'cover' puts
    the structured fmask in tile 1."""
    src = scaled['raw'] if kind == 'device_scale' else \
        [t[:6] for t in inputs[kind]]
    bands = [torch.stack([src[k][j] for k in range(b)]) for j in range(6)]
    fm = [inputs['int16'][k][6] for k in range(b)]
    if mode == 'cover' and b > 1:
        fm[1] = fmasks['structured']
    inv = torch.stack([inputs['int16'][k][7] for k in range(b)])
    kw = {}
    if kind == 'device_scale':
        kw = dict(scales=scaled['scales'][:b].contiguous(),
                  offsets=scaled['offsets'][:b].contiguous())
    return bands, torch.stack(fm), inv, kw


def _plane(torch, planes, name, b):
    """An ancillary plane for b tiles, shifted 17 rows from tile to tile."""
    return torch.stack([torch.roll(planes[name], 17 * k, 0)
                        for k in range(b)])


SHARDS = 4  # row shards of a tile in phases 3c and 5c
HALO = 17   # parallel/campaign.py::SPATIAL_HALO


def _shards(height, halo):
    """(a0, a1, r0, r1) of each row shard: its padded block [a0, a1) and
    its own rows [r0, r1), as make_spatial_campaign_step cuts them."""
    hl = height // SHARDS
    return [(max(0, j * hl - halo), min(height, (j + 1) * hl + halo),
             j * hl, (j + 1) * hl) for j in range(SHARDS)]


def _blocks(args, kw, a0, a1):
    """The [B, a1 - a0, W] row block of a stack's planes, each contiguous
    (the scales and offsets, [B, 6], are the tiles')."""
    block_kw = {k: (v[:, a0:a1].contiguous()
                    if hasattr(v, 'dim') and v.dim() == 3 else v)
                for k, v in kw.items()}
    return [a[:, a0:a1].contiguous() for a in args], block_kw


def phase_spatial_vs_plain(torch, inputs, planes, fmasks, scaled, copy_bw):
    """K6 spatial: B = 2 stacks cut into 4 row shards (with the 17-row
    halo in 'cover'); every windowed launch against the plain twin on its
    padded block, cropped, and the 4 pieces joined against the unsharded
    K6 launch, bit for bit, in every band kind x mode x ancillaries x
    browse, each launch's body against ``wtr_kernel.window_body`` (at a
    width that is a multiple of 4, the 4-pixel body); then the 4 windowed
    launches of a stack timed against the one unsharded launch, and their
    pass A (``pixel_pass``) and, in 'cover', pass B (``launch_k2``) apart."""
    import itertools
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.ops import wtr_kernel

    say(f'== phase 3c: the spatial launch (K6 spatial) vs plain, 2 x {SIZE}'
        f'x{SIZE} in {SHARDS} row shards')
    err = n_runs = n_counted = 0
    bodies = {}  # px a thread of the body -> launches that took it

    def stacks(kind, mode, extras, browse):
        bands, fm, inv, kw = _stack(torch, inputs, fmasks, scaled, kind, 2,
                                    mode)
        if extras:
            kw.update({name: _plane(torch, planes, name, 2)
                       for name in ('ocean', 'shadow', 'landcover')})
        kw['compute_browse'] = browse
        return [*bands, fm, inv], kw

    for kind, mode, extras, browse in itertools.product(
            ('int16', 'float32', 'device_scale'), wtr_kernel.MODES,
            (False, True), (False, True)):
        cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
        args, kw = stacks(kind, mode, extras, browse)
        what = (f'bands={kind} mode={mode} ancillaries={extras} '
                f'browse={browse}')
        whole = wtr_kernel.wtr_layers_batched(*args, cfg, **kw)
        pieces = {}
        for a0, a1, r0, r1 in _shards(SIZE, HALO if mode == 'cover' else 0):
            block, block_kw = _blocks(args, kw, a0, a1)
            window = (r0 - a0, r1 - r0)
            got, ran = _launched(torch, *block, config=cfg, **block_kw,
                                 window=window)
            want = wtr_kernel.wtr_layers_batched_plain(
                *block, cfg, **block_kw, window=window)
            torch.cuda.synchronize()
            label = f'{what}, rows {r0}..{r1 - 1}'
            err = max(err, _compare(torch, got, want, label))
            if window[1] == a1 - a0:  # the block is its window: unwindowed
                # (per-tile scales need H * W a multiple of 8 for 8 px)
                body = 1 if kind == 'device_scale' \
                    and (a1 - a0) * SIZE % 8 else 8
                if ran != body:
                    raise AssertionError(f'{label}: the body of {ran} px a '
                                         f'thread ran, expected {body}')
            else:
                _check_window_body(label, ran, SIZE, [*block, *(
                    v for v in block_kw.values() if hasattr(v, 'dim'))],
                    got)
                if SIZE % wtr_kernel.WINDOW_VEC == 0 and ran == 1:
                    raise AssertionError(f'{label}: the one-pixel body ran')
            bodies[ran] = bodies.get(ran, 0) + 1
            if extras and not browse:
                # the spatial step's counts: valid without the ocean term
                counted, _ = _launched(torch, *block, config=cfg,
                                       **block_kw, window=window,
                                       ocean_in_valid=False)
                want_counts = wtr_kernel.wtr_layers_batched_plain(
                    *block, cfg, **block_kw, window=window,
                    ocean_in_valid=False)
                torch.cuda.synchronize()
                _compare(torch, {k: counted[k] for k in wtr_kernel.COUNTS},
                         {k: want_counts[k] for k in wtr_kernel.COUNTS},
                         f'{label}, valid without the ocean term')
                n_counted += 1
                del counted, want_counts
            for name, t in got.items():
                pieces.setdefault(name, []).append(t)
            del block, block_kw, want
        # the layers' row pieces joined, the counts of the shards' rows
        # summed
        joined = {name: torch.stack(p).sum(0) if name in wtr_kernel.COUNTS
                  else torch.cat(p, dim=1) for name, p in pieces.items()}
        err = max(err, _compare(torch, joined, whole,
                                f'{what}: shards joined vs unsharded'))
        n_runs += 1
        del args, kw, whole, pieces, joined
    say(f'windowed launches == plain twin on their padded blocks, and the '
        f'joined shards == the unsharded K6 launch, bit for bit, in '
        f'{n_runs} combinations (int16/float32/device-scale x mask/ignore/'
        f'cover x ancillaries x browse), {SHARDS * n_runs} windowed '
        f'launches; their coverage counts == coverage_counts of the '
        f"windows' rows, the shards' sums == the unsharded launch's, and "
        f'{n_counted} launches more with valid pixels without the ocean '
        f"term (the spatial step's) == coverage_counts; max |err| {err}; "
        f'launches by the px a thread of their '
        f'body: {bodies} (the blocks of \'mask\' and \'ignore\' are their '
        f'windows: unwindowed, 8, or 1 with per-tile scales on H * W % 8 = '
        f'{(SIZE // SHARDS) * SIZE % 8})')

    # the 4 windowed launches of a stack against the one unsharded launch,
    # at the main path's flags (shadow + landcover, browse; full outputs)
    stats = {}
    for mode in ('cover', 'mask'):
        cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
        args, kw = stacks('int16', mode, False, True)
        kw.update(shadow=_plane(torch, planes, 'shadow', 2),
                  landcover=_plane(torch, planes, 'landcover', 2))
        cut = _shards(SIZE, HALO if mode == 'cover' else 0)
        blocks = [(*_blocks(args, kw, a0, a1), (r0 - a0, r1 - r0))
                  for a0, a1, r0, r1 in cut]

        def sharded(fn=wtr_kernel.wtr_layers_batched):
            for block, block_kw, window in blocks:
                fn(*block, cfg, **block_kw, window=window)

        def whole():
            wtr_kernel.wtr_layers_batched(*args, cfg, **kw)
        # pass A alone (the per-pixel launch) and, in 'cover', pass B
        # alone (K2's dilations) on the state and layers of a pass A run
        parts = {'sharded': blocks, 'whole': [(args, kw, None)]}
        passed = {key: [(wtr_kernel.pixel_pass(*a, cfg, **k, window=w), w)
                        for a, k, w in items] for key, items in parts.items()}

        def pass_a(key):
            for a, k, w in parts[key]:
                wtr_kernel.pixel_pass(*a, cfg, **k, window=w)

        def pass_b(key):
            for (out, state, flags, _, _), w in passed[key]:
                wtr_kernel.launch_k2(state, out, flags,
                                     row0=0 if w is None else w[0])
        timed = [('sharded', sharded, 10), ('whole', whole, 10),
                 ('sharded_a', lambda: pass_a('sharded'), 10),
                 ('whole_a', lambda: pass_a('whole'), 10)]
        if mode == 'cover':
            timed += [('sharded_b', lambda: pass_b('sharded'), 10),
                      ('whole_b', lambda: pass_b('whole'), 10)]
        timed.append(('plain', lambda: sharded(
            wtr_kernel.wtr_layers_batched_plain), 3))
        runs = {key: [] for key, _, _ in timed}
        for key, fn, reps in timed + [t for t in reversed(timed)
                                      if t[0] != 'plain']:
            runs[key].append(_time_ms(torch, fn, [()], reps) / 2)
        ms = {k: statistics.median(v) for k, v in runs.items()}
        rows_read = sum(a1 - a0 for a0, a1, _, _ in cut)
        bound = _spatial_bound(mode, rows_read)
        took = [vec for (*_, vec), _ in passed['sharded']]
        split = f'pass A {ms["sharded_a"]:.4f} (runs {runs["sharded_a"]})'
        whole_split = f'pass A {ms["whole_a"]:.4f} (runs {runs["whole_a"]})'
        if mode == 'cover':
            split += f', pass B {ms["sharded_b"]:.4f} (runs ' \
                f'{runs["sharded_b"]})'
            whole_split += f', pass B {ms["whole_b"]:.4f} (runs ' \
                f'{runs["whole_b"]})'
        say(f'wtr_k6_spatial ({mode!r}, int16, B=2; shadow + landcover + '
            f'browse): {SHARDS} windowed launches {ms["sharded"]:.4f} '
            f'ms/tile (runs {runs["sharded"]}; {split}; px a thread of '
            f'each shard\'s body {took}), the unsharded launch '
            f'{ms["whole"]:.4f} (runs {runs["whole"]}; {whole_split}), '
            f'plain twin {ms["plain"]:.4f} (runs {runs["plain"]}); the '
            f'blocks read {rows_read} of {SIZE} rows, bound '
            f'{bound["bound_ms"]:.4f} ms ({bound["bound_by"]}), '
            f'{bound["bound_ms"] / ms["sharded"]:.1%} of the kernel time; '
            f'device copy {copy_bw / 1e9:.1f} GB/s')
        stats[mode] = {'max_abs_err': err, 'ms': ms['sharded'],
                       'plain_ms': ms['plain'], **bound}
        del args, kw, blocks, parts, passed
    return {'wtr_k6_spatial': stats['cover']}


def _spatial_bound(mode, rows_read):
    """The least time for a tile's shards at the main path's flags: the
    per-pixel pass reads 16 B/px over every block row and writes 9 B/px
    of the tile's rows; in 'cover' the state pass (K2's pass A) runs over
    the block rows and the dilations and full outputs over the tile's."""
    cover = mode == 'cover'
    px_read, px = rows_read * SIZE, SIZE * SIZE
    by_bytes = (16 * px_read + 9 * px) / PEAK_BYTES_PER_S * 1e3
    pass_a = _OPS['tests_int16'] + _OPS['body'] + (
        _OPS['cover_state'] if cover else _OPS['snow_bit'])
    ops = pass_a * px_read + (_OPS['dilations'] if cover else 0) * px \
        + _OPS['full_outputs'] * px
    by_ops = ops / PEAK_OPS_PER_S * 1e3
    return {'bound_ms': max(by_bytes, by_ops),
            'bound_by': 'bytes' if by_bytes >= by_ops else 'operations',
            'library_ms': None}


def phase_null_vs_plain(torch, inputs, copy_bw):
    """The traffic-floor null kernel (``ops/null_kernel.py::null_fold``)
    against its plain twin on the card, bit for bit: int16, float32 and
    mixed inputs, 1, 3 and 8 of them, an unaligned slice and a ragged tail
    (the scalar kernel); then its time on the profile tool's footprint (6
    bands + fmask + invalid) for int16 and float32 bands."""
    import numpy as np
    from proteus_tpu_torch.ops import null_kernel
    from proteus_tpu_torch.ops.null_kernel import null_fold, null_fold_plain

    say(f'== phase 3d: the null kernel vs its plain twin, {SIZE}x{SIZE}')
    device = torch.device(DEVICE)
    rng = np.random.default_rng(20261018)
    # float32 planes with fractions of both signs (the cast truncates
    # toward zero), well inside int32
    wide = [torch.from_numpy(rng.uniform(-30000, 30000, (SIZE, SIZE))
                             .astype(np.float32)).to(device)
            for _ in range(2)]
    i16, f32 = inputs['int16'][0], inputs['float32'][0]
    n = SIZE * SIZE
    cases = {
        'int16 bands + fmask + invalid (8)': (i16, True),
        'float32 bands + fmask + invalid (8)': (f32, True),
        'int16 (1)': (i16[:1], True),
        'uint8 (1)': (i16[6:7], True),
        'float32, wide (1)': (wide[:1], True),
        'int16, uint8, float32 (3)': ((i16[0], i16[6], wide[0]), True),
        'float32, bool, int16 (3)': ((wide[1], i16[7], i16[3]), True),
        'mixed (8)': ((i16[0], wide[0], i16[6], f32[1], i16[7], i16[2],
                       wide[1], f32[5]), True),
        # a slice that starts 3 elements into each plane: no pointer is
        # aligned to its vector, the scalar kernel takes all of it
        'mixed (8), unaligned': (tuple(
            t.reshape(-1)[3:n - 2] for t in (*i16[:3], *f32[3:6], i16[6],
                                             i16[7])), False),
        # aligned, n % 8 = 3: the vector kernel and a scalar tail
        'int16 (8), ragged tail': (tuple(t.reshape(-1)[:n - 5]
                                         for t in i16), True),
        # the rows 1.. of tile 1 of a [2, H, W] stack
        'stack rows (3)': (tuple(torch.stack([t, t])[1, 1:]
                                 for t in (i16[0], i16[6], f32[0])),
                           (SIZE % 8 == 0)),
    }
    err = 0
    for what, (args, vectorized) in cases.items():
        # the wrapper's launch, which also says which kernel it took
        null_kernel._check(args)
        got, took_vector = null_kernel._launch(args)
        want = null_fold_plain(*args)
        torch.cuda.synchronize()
        err = max(err, _compare(torch, {'null': got}, {'null': want},
                                f'null kernel, {what}'))
        if took_vector != vectorized:
            raise AssertionError(
                f'null kernel, {what}: vector kernel {took_vector}, '
                f'expected {vectorized}')
    n_cases = len(cases)
    del wide, cases
    say(f'null kernel == plain twin, bit for bit, in {n_cases}'
        f' cases (int16 / float32 / uint8 / bool planes, 1, 3 and 8 inputs, '
        f'an unaligned slice and a ragged tail through the scalar kernel); '
        f'max |err| {err}')

    stats = {}
    for kind in ('int16', 'float32'):
        sets = inputs[kind]
        plain_ms = [_time_ms(torch, null_fold_plain, sets, 3)]
        kernel_ms = [_time_ms(torch, null_fold, sets, 10),
                     _time_ms(torch, null_fold, sets, 10)]
        plain_ms.append(_time_ms(torch, null_fold_plain, sets, 3))
        ms, pms = statistics.median(kernel_ms), statistics.median(plain_ms)
        tile_bytes = NULL_BYTES_PER_PX[kind] * n
        bound = _bound('null', tile_bytes)
        say(f'null ({kind} bands + fmask + invalid): kernel {ms:.4f} ms/tile '
            f'(runs {kernel_ms}), plain twin {pms:.4f} ms/tile (runs '
            f'{plain_ms}); {NULL_BYTES_PER_PX[kind]} B/px = '
            f'{tile_bytes / 1e6:.1f} MB/tile = '
            f'{tile_bytes / (ms * 1e-3) / 1e9:.1f} GB/s, '
            f'{tile_bytes / (ms * 1e-3) / copy_bw:.1%} of the device copy '
            f'({copy_bw / 1e9:.1f} GB/s); bound {bound["bound_ms"]:.4f} ms '
            f'({bound["bound_by"]}), {bound["bound_ms"] / ms:.1%} of the '
            f'kernel time')
        stats[kind] = {'max_abs_err': err, 'ms': ms, 'plain_ms': pms,
                       **bound}
    if null_kernel.LAUNCHES['null'] < 1:
        raise AssertionError('the null kernel was never launched')
    return {'null': stats['int16']}


# operations of the warp kernel's steps, counted line by line in
# csrc/warp_kernel.cuh on the path this run's data takes (regular pixels
# whose products all pass the FMA's test; no pixel runs again with
# Dekker's split): one for each add, subtract, multiply, divide,
# compare, select, logical operation, shift, convert, floor, abs, min and
# max, two for a fused multiply-add, as the 67 TFLOP/s float32 rate counts
# one (a negation folds into its add; loads and stores are the bytes
# side). The kernel fuses nothing else, by design: an unfused add or
# multiply issues at half the rate that convention assumes, so an unfused
# mix cannot pass about 50% of this bound.
_W = {'two_sum': 6,
      'dd_norm': 3,
      'near_edge': 8,             # abs, add, multiply, add, subtract, 2
                                  # compares, or
      # the shift, clamp (compare, select), the shift back, subtract,
      # convert, multiply of a row's or a column's cell
      'cell': 7,
      # in_window (2 compares, and), the clamp (2 compares, 2 selects), the
      # row's multiply; a wrapping column's remainder (%, compare, add,
      # select)
      'gather_row': 3 + 4 + 1, 'gather_col': 3 + 4, 'wrap': 4,
      # f32 boundary band: |hi| + 1e-30 (2), next_up (compare, add,
      # select), half ulp (2), coord_mag (4), spread (a subtract,
      # nan_to_num's compare, abs, compare, or and select), delta (5
      # multiplies, 2 adds), the test (2 abs, subtract, compare, or)
      'band': 2 + 3 + 2 + 4 + 6 + 7 + 5}
# two_prod's FMA: p, the fused multiply-add, and the test of its operands
# folded into the pixel's flag: |p| against 2^-100, a == 0, b == 0, 2 ors
# and the flag's and (one compare and or fewer where b is a constant);
# a lattice difference's bound (compare, and), a source value's or a
# quotient's (2 compares, 2 ands)
_W['two_prod'] = {'bounded': 1 + 2 + 3 + 2 + 1, 'constant': 1 + 2 + 2 + 1 + 1,
                  'any_a': 1 + 2 + 3 + 2 + 1 + 2,
                  'any_b': 1 + 2 + 3 + 2 + 1 + 4}
_W['dd_add'] = _W['two_sum'] + 2 + _W['dd_norm']
_W['dd_mul_f32'] = {k: n + 2 + _W['dd_norm']
                    for k, n in _W['two_prod'].items()}
_W['dd_mul'] = _W['two_prod']['bounded'] + 4 + _W['dd_norm']
# the row lerp of a staged column (the difference, its product, the sum)
# and its difference to the next column; a pixel's column lerp
_W['dd_lerp'] = 2 * _W['dd_add'] + _W['dd_mul_f32']['any_a']
_W['stage'] = _W['dd_lerp'] + _W['dd_add']
_W['column_lerp'] = _W['dd_mul_f32']['any_a'] + _W['dd_add']
# floor, the two TwoSums and the add between, the shift (2 compares, 2
# selects), the fraction's dd_add, the index (subtract, convert)
_W['dd_floor'] = 1 + 2 * _W['two_sum'] + 1 + 4 + _W['dd_add'] + 2
# the column's cell, the column lerps of u and v and the flag's branch
_W['interp'] = _W['cell'] + 2 * _W['column_lerp'] + 1
_W['poly_inner'] = _W['dd_mul_f32']['constant'] + 2 * _W['dd_add'] \
    + 2 * _W['dd_mul']
_W['poly_outer'] = _W['dd_mul_f32']['constant'] + 3 * _W['dd_add'] \
    + 2 * _W['dd_mul']
# the four cubic weights of one axis: f + 1, 1 - f, 2 - f and the polynomials
_W['cubic_weights'] = 3 * _W['dd_add'] + 2 * _W['poly_inner'] \
    + 2 * _W['poly_outer']
# a tap's accumulation: fast (|term| and its add, fminf, fmaxf, the dd
# sum), unmasked-wrap (+ the weight sum), masked (ok: 2 ands and the
# validity's compare; the selects of |term|, vmin, vmax and the 4 dd
# operands, and both dd sums)
_W['accumulate'] = {0: 2 + 2 + _W['dd_add'],
                    1: 2 + 2 + 2 * _W['dd_add'],
                    2: 3 + 2 + 1 + 2 + 2 + 4 + 2 * _W['dd_add']}
# the dd division (compare and select, 2 divides, the Newton step's
# products and sums), good (compare, and), the two ambiguity tests and
# err_scale (abs, max, divide)
_W['divide'] = 2 + 2 + _W['dd_mul_f32']['any_b'] + _W['dd_add'] \
    + _W['two_sum'] + _W['dd_norm'] + 2 + 4 + 4 + 3


def _warp_ops(algorithm, mode, wraps, out_h, out_w, gw):
    """The operations of one warp: each pixel's and each staged lattice
    column's (the row lerps of u and v)."""
    px = _W['interp'] + 2 * _W['dd_floor'] + 2 * _W['near_edge'] + 1
    col = _W['gather_col'] + (_W['wrap'] if wraps else 0)
    if algorithm == 'nearest':
        # in_range (3, 4 more without a wrap), the row and column, the flat
        # index's add, ok (2 ands, the validity's compare), the select,
        # amb's and
        px += (3 if wraps else 7) + _W['gather_row'] + col + 1 + 3 + 1 + 1
    else:
        taps = 2 if algorithm == 'bilinear' else 4
        weights = 2 * (_W['dd_add'] if taps == 2 else _W['cubic_weights'])
        # the flat index's add, the weights' product, the term
        tap = 1 + _W['dd_mul'] + _W['dd_mul_f32']['any_b'] \
            + _W['accumulate'][mode]
        # the dd u - 0.5 and v - 0.5, center_in, each tap row's and
        # column's gather, the regular test (2 abs, 2 compares, and) and
        # the flag's branch, the taps, the division, the band, amb's and
        # and good's select
        px += 2 * _W['dd_add'] + weights + (3 if wraps else 7) \
            + taps * (_W['gather_row'] + col) + 6 + taps * taps * tap \
            + (_W['divide'] if mode else 0) + _W['band'] + 2
    return px * out_h * out_w + 2 * _W['stage'] * out_h * gw


def _warp_bound(args, out_bytes):
    """The least time of one warp: each input read once (the source window,
    its validity, the lattice) and out and amb written once, over the
    card's memory rate, against its operations over the float32 rate."""
    data, valid, lat, _, out_h, out_w, algorithm, _, wraps, _ = args
    mode = 2 if valid is not None else (1 if wraps else 0)
    # nearest reads one element a pixel at most, however large the window
    read = data.numel() if algorithm != 'nearest' \
        else min(data.numel(), out_h * out_w)
    nbytes = read * data.element_size() + out_bytes \
        + (valid.numel() if valid is not None else 0) \
        + sum(t.numel() * 4 for t in lat)
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = _warp_ops(algorithm, mode, wraps, out_h, out_w,
                       lat[0].shape[1]) / PEAK_OPS_PER_S * 1e3
    return {'bound_ms': max(by_bytes, by_ops),
            'bound_by': 'bytes' if by_bytes >= by_ops else 'operations',
            'library_ms': None}


class _Captured(Exception):
    pass


def _warp_args(torch, path, gt, length, width, algorithm, margin=0,
               grid_spacing=None):
    """The arguments ``warp_to_grid_device`` hands ``device_resample`` for
    one source on the card: the source window, its validity, the lattice,
    the geometry and the fill (the call itself is not made)."""
    from proteus_tpu_torch.geo import warp
    from proteus_tpu_torch.geo.crs import CRS
    from proteus_tpu_torch.testing import synthetic
    got = []

    def capture(*args, **kw):
        got.append(args + (kw['wraps'], kw['full_width']))
        raise _Captured

    real, warp.device_resample = warp.device_resample, capture
    try:
        warp.warp_to_grid_device(
            path, gt, CRS.from_epsg(synthetic.EPSG).to_wkt(), length, width,
            resample_algorithm=algorithm, margin_in_pixels=margin,
            grid_spacing=grid_spacing, device=torch.device(DEVICE))
    except _Captured:
        pass
    finally:
        warp.device_resample = real
    return got[0]


def _peak_growth(torch, fn, args):
    """One call's result and its peak device memory above what was
    allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    result = fn(*args)
    torch.cuda.synchronize()
    return result, torch.cuda.max_memory_allocated() - base


def phase_warp_vs_plain(torch, workdir):
    """The warp kernel (``ops/warp_kernel.py``, through
    ``geo/warp.py::device_resample``) against ``device_resample_plain`` on
    the same card tensors, bit for bit: the synthetic tile's own sources
    as ``warp_to_grid_device`` hands them over (the DEM with its 50 px
    margin, cubic; CGLS and WorldCover, nearest), the DEM with NaN holes
    (masked mode, cubic and bilinear), int16 and float32 nearest with a
    validity mask, the DEM's and CGLS's lattices shifted half a window
    west over a wrapping source, the DEM with the TwoProduct's edge
    values, lattices that take its Dekker path, a uint8 window of more
    than 2^31 elements, lattice rows that a block stages in column chunks
    and output sides past 2^24. Then each case's peak device memory of one
    call and its time, the plain twin's too in four cases, beside the
    bound; and ``warp_to_grid_device`` at grid spacing 1 against the host
    warp, with its one launch."""
    import numpy as np
    from proteus_tpu_torch.geo import warp
    from proteus_tpu_torch.ops import warp_kernel
    from proteus_tpu_torch.ops.build import build
    from proteus_tpu_torch.testing import synthetic

    lib = build('warp_kernel').lib
    say(f'== phase 3e: the warp kernel vs its plain twin on the synthetic '
        f'tile\'s sources, {SIZE}x{SIZE}')
    t0 = time.perf_counter()
    src = os.path.join(workdir, 'warp_sources')
    os.makedirs(src)
    files = {'dem': synthetic.make_dem(src, size=SIZE),
             'cgls': synthetic.make_landcover(src, size=SIZE),
             'wc': synthetic.make_worldcover(src, size=SIZE)}
    gt = synthetic.geotransform()
    gt3 = (gt[0], gt[1] / 3, 0.0, gt[3], 0.0, gt[5] / 3)
    dem = _warp_args(torch, files['dem'], gt, SIZE, SIZE, 'cubic', 50)
    cgls = _warp_args(torch, files['cgls'], gt, SIZE, SIZE, 'nearest')
    wc = _warp_args(torch, files['wc'], gt3, 3 * SIZE, 3 * SIZE, 'nearest')
    say(f'sources written and their lattices made in '
        f'{time.perf_counter() - t0:.1f} s; windows: DEM '
        f'{tuple(dem[0].shape)}, CGLS {tuple(cgls[0].shape)}, WorldCover '
        f'{tuple(wc[0].shape)}; lattices {tuple(dem[2][0].shape)}, '
        f'{tuple(cgls[2][0].shape)}, {tuple(wc[2][0].shape)} (spacing '
        f'{dem[3]}, {cgls[3]}, {wc[3]})')
    if dem[1] is not None or cgls[1] is not None or wc[1] is not None:
        raise AssertionError('a synthetic source has nodata pixels')

    rng = np.random.default_rng(20261019)
    d = dem[0].cpu().numpy()
    yy, xx = np.mgrid[0:d.shape[0], 0:d.shape[1]]
    holes = ((yy - d.shape[0] // 2) ** 2 + (xx - d.shape[1] // 3) ** 2
             < (d.shape[0] // 10) ** 2) | (rng.random(d.shape) < 0.01)
    d = d.copy()
    d[holes] = np.nan
    dem_holes = torch.from_numpy(d).to(DEVICE)
    valid = torch.from_numpy(~holes).to(DEVICE)
    dem_i16 = torch.round(dem[0]).to(torch.int16)

    def west(lat, w):
        # the lattice moved half a window west: columns < 0 wrap
        return (lat[0] - w // 2, lat[1], lat[2], lat[3])

    h_d, w_d = dem[0].shape
    w_c = cgls[0].shape[1]
    nan = float('nan')
    inf = float('inf')
    # the TwoProduct's edges among the DEM's values (2% of its pixels): +-0,
    # subnormals, the least normal, +-inf, NaN, +-3e38
    edges = np.array([0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45,
                      1.1754942e-38, inf, -inf, nan, 3e38, -3e38],
                     np.float32)
    d = dem[0].cpu().numpy().copy()
    pick = rng.random(d.shape) < 0.02
    d[pick] = rng.choice(edges, int(pick.sum()))
    dem_edges = torch.from_numpy(d).to(DEVICE)
    del d

    def tiny(lat):
        # each hi plane the same along one axis, the lo planes about 1e-30
        # apart: those lerps' differences are about 1e-30, below the FMA's
        # product limit (Dekker's split)
        shape = tuple(lat[0].shape)
        lo = [torch.from_numpy(rng.uniform(-1e-30, 1e-30, shape)
                               .astype(np.float32)).to(DEVICE)
              for _ in range(2)]
        return (lat[0][:1].expand(shape).contiguous(), lo[0],
                lat[2][:, :1].expand(shape).contiguous(), lo[1])

    def huge(lat):
        # u x 1e30: its differences along a lattice row pass the FMA's
        # operand bound of 2^100 (Dekker's split), and a wrapping source's
        # pixels take the taps' unbounded weights (kUnknown)
        return (lat[0] * 1e30, lat[1] * 1e30, lat[2], lat[3])

    # a uint8 source of 46,400^2 (2.15 GB, more than 2^31 elements: 64-bit
    # indices) under a 3660^2 grid whose last rows read beyond 2^31
    big = 46400
    gh, gw = cgls[2][0].shape
    gi = np.arange(gh, dtype=np.float64)[:, None] * cgls[3]
    gj = np.arange(gw, dtype=np.float64)[None, :] * cgls[3]
    scale = (big - 10) / (SIZE - 1)
    big_lat = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
        for x in (gj * scale + 1e-3 * gi + 0.3, gi * scale - 1e-3 * gj + 0.2)
        for a in warp._dd_split(x))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(20261017)
    big_data = torch.randint(0, 255, (big, big), dtype=torch.uint8,
                             device=DEVICE, generator=gen)
    if big * big < 2 ** 31:
        raise AssertionError('the big window takes 32-bit indices')

    def lattice(out_h, out_w, spacing, u, v):
        # the dd lattice of u(gi, gj) and v(gi, gj) at a grid's nodes
        gh = len(range(0, out_h + 2 * spacing, spacing))
        gw = len(range(0, out_w + 2 * spacing, spacing))
        gi = np.arange(gh, dtype=np.float64)[:, None] * spacing
        gj = np.arange(gw, dtype=np.float64)[None, :] * spacing
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
                     for x in (u(gi, gj), v(gi, gj))
                     for a in warp._dd_split(x))

    # lattice rows wider than a block's 7,264 staged columns (column
    # chunks), and output sides past 2^24 (the twin's
    # rounded float32 row and column numbers): WorldCover at grid spacing 1
    # through warp_to_grid_device; the DEM on a 256 x WIDE_SIDE grid at
    # spacing 8; a uint8 source (spacing 8) and the DEM (spacing 1) on
    # 2 x LONG_SIDE grids
    wc1 = _warp_args(torch, files['wc'], gt3, 256, 3 * SIZE, 'nearest',
                     grid_spacing=1)
    wide_lat = lattice(
        256, WIDE_SIDE, 8,
        lambda gi, gj: gj * ((w_d - 10) / WIDE_SIDE) + 1e-3 * gi + 2.3,
        lambda gi, gj: gi * ((h_d - 10) / 256) + 1e-4 * gj + 1.7)
    long8 = lattice(
        2, LONG_SIDE, 8,
        lambda gi, gj: gj * (4086 / LONG_SIDE) + 0.25 * gi + 0.3,
        lambda gi, gj: gj * (1014 / LONG_SIDE) + 0.5 * gi + 0.2)
    long1 = lattice(
        2, LONG_SIDE, 1,
        lambda gi, gj: gj * ((w_d - 10) / LONG_SIDE) + 0.25 * gi + 2.3,
        lambda gi, gj: gj * ((h_d - 10) / LONG_SIDE) + 0.5 * gi + 1.7)
    long_data = torch.randint(0, 255, (1024, 4096), dtype=torch.uint8,
                              device=DEVICE, generator=gen)
    cases = {
        'DEM cubic (fast)': dem,
        'DEM with holes, cubic (masked)':
            (dem_holes, valid) + dem[2:],
        'DEM with holes, bilinear (masked)':
            (dem_holes, valid) + dem[2:6] + ('bilinear',) + dem[7:],
        'CGLS nearest, uint8': cgls,
        'WorldCover nearest, uint8': wc,
        'DEM nearest, int16, holes (fill -32768)':
            (dem_i16, valid) + dem[2:6] + ('nearest', -32768) + dem[8:],
        'DEM nearest, float32, holes (fill NaN)':
            (dem_holes, valid) + dem[2:6] + ('nearest', nan) + dem[8:],
        'DEM cubic, wrapping (unmasked-wrap)':
            dem[:2] + (west(dem[2], w_d),) + dem[3:8] + (True, w_d),
        'DEM with holes, bilinear, wrapping (masked)':
            (dem_holes, valid, west(dem[2], w_d)) + dem[3:6]
            + ('bilinear',) + dem[7:8] + (True, w_d),
        'CGLS nearest, wrapping':
            cgls[:2] + (west(cgls[2], w_c),) + cgls[3:8] + (True, w_c),
        'DEM with edge values, cubic (fast)': (dem_edges,) + dem[1:],
        'DEM with edge values, cubic (masked)':
            (dem_edges, valid) + dem[2:],
        'DEM with edge values, bilinear (fast)':
            (dem_edges,) + dem[1:6] + ('bilinear',) + dem[7:],
        'DEM cubic, lattice differences ~1e-30':
            dem[:2] + (tiny(dem[2]),) + dem[3:],
        'CGLS nearest, lattice differences ~1e-30':
            cgls[:2] + (tiny(cgls[2]),) + cgls[3:],
        'DEM cubic, wrapping, u x 1e30':
            dem[:2] + (huge(west(dem[2], w_d)),) + dem[3:8] + (True, w_d),
        'CGLS nearest, u x 1e30': cgls[:2] + (huge(cgls[2]),) + cgls[3:],
        'uint8 nearest, 46400^2 window (64-bit indices)':
            (big_data, None, big_lat, cgls[3], SIZE, SIZE, 'nearest', 255,
             False, None),
        'WorldCover nearest, grid spacing 1': wc1,
        'DEM with holes, cubic (masked), spacing 8':
            (dem_holes, valid, wide_lat, 8, 256, WIDE_SIDE, 'cubic', dem[7],
             False, None),
        'DEM cubic, wrapping (unmasked-wrap), spacing 8':
            (dem[0], None, west(wide_lat, w_d), 8, 256, WIDE_SIDE, 'cubic',
             dem[7], True, w_d),
        'DEM with holes, cubic, wrapping (masked), spacing 8':
            (dem_holes, valid, west(wide_lat, w_d), 8, 256, WIDE_SIDE,
             'cubic', dem[7], True, w_d),
        'uint8 nearest, spacing 8, sides past 2^24':
            (long_data, None, long8, 8, 2, LONG_SIDE, 'nearest', 255, False,
             None),
        'DEM cubic, spacing 1, sides past 2^24':
            (dem[0], None, long1, 1, 2, LONG_SIDE, 'cubic', dem[7], False,
             None),
    }
    # output rows whose v (i * scale + 0.2, less 4 at most across a row)
    # passes the first row past 2^31 elements of the big window
    beyond = int(np.ceil((-(-2 ** 31 // big) + 4) / scale))
    stats = {}
    for what, args in cases.items():
        want, plain_peak = _peak_growth(torch, warp.device_resample_plain,
                                        args)
        got, peak = _peak_growth(torch, warp.device_resample, args)
        out_bytes = got[0].numel() * (got[0].element_size() + 1)
        for name, a, b in (('out', got[0], want[0]), ('amb', got[1],
                                                      want[1])):
            if a.dtype != b.dtype or not torch.equal(a.view(torch.uint8),
                                                     b.view(torch.uint8)):
                n = int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                raise AssertionError(f'warp, {what}: {name} differs from the '
                                     f'plain twin in {n} bytes')
        if args[0] is big_data and not (want[0][beyond:] != 255).any():
            raise AssertionError('no pixel read beyond 2^31 elements')
        err = float((got[0].double() - want[0].double()).abs()
                    .nan_to_num(0.0).max())
        n_amb = int(got[1].sum())
        row = {'max_abs_err': err, 'amb_px': n_amb,
               'peak_bytes': peak, 'plain_peak_bytes': plain_peak,
               **_warp_bound(args, out_bytes)}
        del want, got
        timed = what in ('DEM cubic (fast)', 'WorldCover nearest, uint8',
                         'CGLS nearest, uint8',
                         'DEM with holes, cubic (masked)')
        if timed:
            plain_ms = [_time_ms(torch, warp.device_resample_plain, [args],
                                 2, cycles=1)]
            kernel_ms = [_time_ms(torch, warp.device_resample, [args], 5),
                         _time_ms(torch, warp.device_resample, [args], 5)]
            plain_ms.append(_time_ms(torch, warp.device_resample_plain,
                                     [args], 2, cycles=1))
            row['ms'] = statistics.median(kernel_ms)
            row['plain_ms'] = statistics.median(plain_ms)
            times = (f'; kernel {row["ms"]:.4f} ms (runs {kernel_ms}), plain '
                     f'{row["plain_ms"]:.4f} ms (runs {plain_ms}), bound '
                     f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}), '
                     f'{row["bound_ms"] / row["ms"]:.1%} of the kernel time')
        else:
            row['ms'] = _time_ms(torch, warp.device_resample, [args], 3)
            times = (f'; kernel {row["ms"]:.4f} ms, bound '
                     f'{row["bound_ms"]:.4f} ms ({row["bound_by"]})')
        gw = args[2][0].shape[1]
        chunks = warp_kernel.chunking(lib, gw, *args[3:6])[1] // args[4]
        say(f'warp, {what}: {tuple(args[0].shape)} -> {args[4]}x{args[5]} '
            f'(lattice row {gw} columns, {chunks} block(s) a row); out and '
            f'amb == plain twin bit for bit, amb {n_amb} px; one call\'s '
            f'peak device memory {peak / 2**20:.1f} MiB (plain '
            f'{plain_peak / 2**20:.1f} MiB){times}')
        stats[what] = row
    if min(warp_kernel.LAUNCHES.values()) < 1:
        raise AssertionError(f'warp launches {warp_kernel.LAUNCHES}')
    say(f'warp kernel == plain twin, bit for bit, in {len(cases)} cases; '
        f'launches {warp_kernel.LAUNCHES}')
    # the public function at grid spacing 1: one nearest launch, and the
    # host float64 warp's values
    from proteus_tpu_torch.geo.crs import CRS
    wkt = CRS.from_epsg(synthetic.EPSG).to_wkt()
    before = dict(warp_kernel.LAUNCHES)
    got = warp.warp_to_grid_device(
        files['wc'], gt3, wkt, 256, 3 * SIZE, resample_algorithm='nearest',
        grid_spacing=1, device=torch.device(DEVICE))
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in warp_kernel.LAUNCHES.items()}
    want = warp.warp_to_grid(files['wc'], gt3, wkt, 256, 3 * SIZE,
                             resample_algorithm='nearest', grid_spacing=1)
    if launched != {'warp_nearest': 1, 'warp_bilinear': 0, 'warp_cubic': 0}:
        raise AssertionError(f'warp_to_grid_device at grid spacing 1 '
                             f'launched {launched}')
    if not np.array_equal(got.cpu().numpy(), want):
        raise AssertionError('warp_to_grid_device at grid spacing 1 differs '
                             'from the host warp')
    say(f'warp_to_grid_device, WorldCover 256x{3 * SIZE} at grid spacing 1: '
        f'launches {launched}, == host float64 warp_to_grid')
    return {'warp_nearest': stats['WorldCover nearest, uint8'],
            'warp_cubic': stats['DEM cubic (fast)']}


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _reset_counts():
    """Set the launch counts of the main paths' kernels (the per-pixel
    slices and the warp) to 0."""
    from proteus_tpu_torch.ops import warp_kernel, wtr_kernel
    for counts in (wtr_kernel.LAUNCHES, warp_kernel.LAUNCHES):
        for name in counts:
            counts[name] = 0


def _read_counts():
    """The launch counts of the per-pixel slices and the warp."""
    from proteus_tpu_torch.ops import warp_kernel, wtr_kernel
    return {**wtr_kernel.LAUNCHES, **warp_kernel.LAUNCHES}


def _run_cli(torch, label, argv, expect):
    """One product run through the CLI's ``main`` with the launch counts
    set to 0 just before it; checks that each slice in ``expect`` launched
    and returns the counts."""
    from proteus_tpu_torch.cli.dswx_hls import main as dswx_hls_main

    log = logging.getLogger('dswx_hls')
    collect = _Collect()
    log.addHandler(collect)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        ok = dswx_hls_main(argv)
    finally:
        # the CLI routes stdout/stderr into its logger
        sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
        log.removeHandler(collect)
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    if ok is not True:
        raise AssertionError(f'run {label}: generate_dswx_layers returned '
                             f'{ok!r}')
    for name in expect:
        if launches[name] < 1:
            raise AssertionError(f'run {label} never launched {name}')
    say(f'run {label}: {wall:.2f} s wall, launches {launches}, peak device '
        f'memory {peak / 2**30:.3f} GiB')
    for line in collect.lines:
        if 'device chain on' in line:
            say(f'  {line}')
    start = collect.lines.index('stage timing breakdown:')
    for line in collect.lines[start:]:
        if line.startswith('    ') or line.endswith(':'):
            say(f'  {line}')
    return launches


def _read_layers(output_dir, product='dswx_hls_test', browse=True):
    from proteus_tpu_torch.io.tiff import TiffReader
    prefix = os.path.join(output_dir, f'{product}_v0.1_')
    layers = ['WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'LAND',
              'SHAD', 'CLOUD', 'DEM']
    got = {}
    for nn, layer in enumerate(layers, start=1):
        with TiffReader(f'{prefix}B{nn:02}_{layer}.tif') as r:
            got[layer] = r.read()
    if not browse:
        return got
    for suffix in ('BROWSE.png', 'BROWSE.tif'):
        if not os.path.isfile(prefix + suffix):
            raise AssertionError(f'missing {prefix + suffix}')
    with TiffReader(prefix + 'BROWSE.tif') as r:
        got['BROWSE'] = r.read()
    return got


def _load_oracle():
    """``tests/oracle.py`` of this checkout (numpy and scipy only), loaded
    by its path; ``sys.path`` stays as it is."""
    import importlib.util
    path = os.path.join(REPO, 'tests', 'oracle.py')
    spec = importlib.util.spec_from_file_location('oracle', path)
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle


def _hold_against_oracle(oracle, label, got, bands, fmask, invalid, mode,
                         ocean=None, thresholds=None):
    """The per-pixel layers vs the numpy oracle, fed the run's own SHAD and
    LAND (as tests/test_workflow.py does); ``thresholds`` are the run's
    changes to the default HlsThresholds."""
    import numpy as np
    from proteus_tpu_torch.core.thresholds import HlsThresholds
    t = HlsThresholds(**(thresholds or {}))
    want = oracle.full_chain(
        *[bands[k] for k in ('blue', 'green', 'red', 'nir', 'swir1',
                             'swir2')], fmask, invalid,
        {k: getattr(t, k) for k in t.__dataclass_fields__}, mode=mode,
        aerosol_lists={0: [224, 160, 96], 2: [224, 160, 96],
                       3: [224, 192, 160, 128, 96],
                       4: [224, 192, 160, 128, 96]},
        ocean_mask=ocean, shadow=got['SHAD'], landcover=got['LAND'])
    for layer in ('WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'CLOUD'):
        expected = want[layer]
        if layer in ('WTR', 'WTR-1', 'WTR-2'):
            expected = oracle.collapse(expected)
        if not np.array_equal(got[layer], expected):
            raise AssertionError(
                f'run {label}: {layer} differs from the oracle in '
                f'{int((got[layer] != expected).sum())} px')
    vals, counts = np.unique(got['WTR'], return_counts=True)
    say(f'  run {label} WTR classes: '
        f'{dict(zip(vals.tolist(), counts.tolist()))}')


def _host_counts(fmask, invalid, mode, ocean=None):
    """A tile's coverage counts on the host: (n_valid, n_cloud_and_valid,
    n_not_ocean), valid = ~invalid and, with ``ocean``, ocean != 0;
    cloudy = preliminary CLOUD != 0 (Fmask bit 1 or 3, and bit 2 in
    'mask' mode)."""
    import numpy as np
    land = np.ones(invalid.shape, bool) if ocean is None else ocean != 0
    valid = ~invalid & land
    cloudy = (fmask & (2 | 8 | (4 if mode == 'mask' else 0))) != 0
    return int(valid.sum()), int((cloudy & valid).sum()), int(land.sum())


def _hold_coverage(label, output_dir, fmask, invalid, mode, ocean=None):
    """The product's coverage metadata (the WTR file's) against the
    host's counts through the reference's percentages
    (runtime/orchestrator.py after the device chain)."""
    import glob
    from proteus_tpu_torch.io.tiff import TiffReader
    n_valid, n_cloudy, n_land = _host_counts(fmask, invalid, mode, ocean)
    want = {'SPATIAL_COVERAGE': int(100 * n_valid / invalid.size),
            'SPATIAL_COVERAGE_EXCLUDING_MASKED_OCEAN':
                0 if n_land == 0 else int(100 * n_valid / n_land),
            'CLOUD_COVERAGE': 0 if n_valid == 0
            else int(100 * n_cloudy / n_valid)}
    wtr, = glob.glob(os.path.join(output_dir, '*_B01_WTR.tif'))
    with TiffReader(wtr) as r:
        md = r.metadata()
    got = {k: int(md[k]) for k in want}
    if got != want:
        raise AssertionError(f'run {label}: coverage metadata {got}, the '
                             f'host counts give {want}')
    say(f'  run {label} coverage metadata == the host counts\' {got} '
        f'(n_valid {n_valid}, n_cloud_and_valid {n_cloudy}, n_not_ocean '
        f'{n_land})')


def _sqrt_on_the_card(torch):
    """``shadow._sqrt`` (x * rsqrt(x), the shadow's and the hillshade's
    square root) on the card against float64: rsqrtf is documented within
    2 ULP and the multiply rounds once more, so within 3 ULP, far inside
    the bands (tests/test_torch_shadow.py holds the CPU to 2)."""
    import numpy as np
    from proteus_tpu_torch.models.dswx import shadow
    rng = np.random.default_rng(11)
    x = np.concatenate([
        rng.uniform(1.0, 2.0, 10 ** 6),
        np.exp2(rng.uniform(-126, 127, 10 ** 6)),
        [0.0, np.inf, 1.0, 4.0]]).astype(np.float32)
    got = shadow._sqrt(torch.from_numpy(x).to(DEVICE)).cpu().numpy()
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    ulps = int(np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64)).max())
    say(f'shadow._sqrt on the card: within {ulps} ULP of float64 on '
        f'{x.size} values')
    if ulps > 3:
        raise AssertionError(f'shadow._sqrt on the card: {ulps} ULP')


def phase_main_path(torch, workdir):
    import shutil
    import numpy as np
    oracle = _load_oracle()
    from proteus_tpu_torch.geo.crs import CRS
    from proteus_tpu_torch.geo.polygon import create_ocean_mask
    from proteus_tpu_torch.geo.warp import warp_to_grid
    from proteus_tpu_torch.io.cog import write_cog
    from proteus_tpu_torch.io.tiff import TiffReader
    from proteus_tpu_torch.models.dswx.shadow import _host_shadow_exact
    from proteus_tpu_torch.testing import synthetic

    say('== phase 4: three product runs through the CLI, full-size '
        'synthetic tile')
    t0 = time.perf_counter()
    input_dir = os.path.join(workdir, 'input')
    files, raw = synthetic.make_hls_v2_dataset(input_dir, size=SIZE)
    dem_file = synthetic.make_dem(workdir, size=SIZE)
    lc_file = synthetic.make_landcover(workdir, size=SIZE)
    wc_file = synthetic.make_worldcover(workdir, size=SIZE)
    shoreline = synthetic.make_shoreline(workdir, size=SIZE)
    # run (a)'s input: the Fmask rewritten with the reference's writer
    input_a = os.path.join(workdir, 'input_a')
    shutil.copytree(input_dir, input_a)
    fmask_a = cover_tile_fmask(raw['Fmask'])
    fmask_file = os.path.join(input_a, os.path.basename(
        [f for f in files if f.endswith('Fmask.tif')][0]))
    with TiffReader(fmask_file) as r:
        md = r.metadata()
    write_cog(fmask_file, fmask_a, geotransform=synthetic.geotransform(),
              epsg=synthetic.EPSG, nodata=255, metadata=md,
              overview_levels=())
    anc = dict(dem_file=dem_file, landcover_file=lc_file,
               worldcover_file=wc_file, check_coverage=True)
    rc = {}
    for label, inp, extra in (
            ('a', input_a, dict(
                shoreline_shapefile=shoreline, apply_ocean_masking=True,
                extra_processing={'mask_adjacent_to_cloud_mode': 'cover'})),
            ('b', input_dir, {}), ('c', input_dir, {})):
        rc[label] = synthetic.write_runconfig(
            os.path.join(workdir, f'rc_{label}.yaml'), inp,
            os.path.join(workdir, f'output_{label}'),
            os.path.join(workdir, f'scratch_{label}'), **anc, **extra)
    say(f'synthetic tile written in {time.perf_counter() - t0:.1f} s')

    invalid = np.zeros((SIZE, SIZE), bool)
    ints = {}
    for key, name in [('blue', 'B02'), ('green', 'B03'), ('red', 'B04'),
                      ('nir', 'B8A'), ('swir1', 'B11'), ('swir2', 'B12')]:
        invalid |= raw[name] == -9999
        ints[key] = np.clip(raw[name], 1, None)
    launches = dict.fromkeys(('wtr_k1', 'wtr_k2', 'wtr_k3'), 0)

    def count(run):
        for name, n in run.items():
            launches[name] = launches.get(name, 0) + n

    # (c) the default run: int16, 'mask' (K1); DEM and SHAD vs the host;
    # the DEM's cubic warp and the CGLS and WorldCover nearest warps
    run = _run_cli(torch, 'c (default: int16, mask)', [rc['c']], ('wtr_k1',))
    warps = {k: run[k] for k in ('warp_nearest', 'warp_bilinear',
                                 'warp_cubic')}
    if warps != {'warp_nearest': 2, 'warp_bilinear': 0, 'warp_cubic': 1}:
        raise AssertionError(f'run c: warp launches {warps}; expected 2 '
                             f'nearest and 1 cubic')
    count(run)
    got = _read_layers(os.path.join(workdir, 'output_c'))
    _hold_against_oracle(oracle, 'c', got, ints, raw['Fmask'], invalid,
                         'mask')
    _hold_coverage('c', os.path.join(workdir, 'output_c'), raw['Fmask'],
                   invalid, 'mask')
    margin = 50
    dem_host = warp_to_grid(dem_file, synthetic.geotransform(),
                            CRS.from_epsg(synthetic.EPSG).to_wkt(), SIZE,
                            SIZE, resample_algorithm='cubic',
                            margin_in_pixels=margin)
    crop = (slice(margin, -margin), slice(margin, -margin))
    if not np.array_equal(got['DEM'], dem_host[crop], equal_nan=True):
        raise AssertionError('DEM differs from the host warp')
    md = synthetic.HLS_METADATA
    shad_host = _host_shadow_exact(
        dem_host, float(md['MEAN_SUN_AZIMUTH_ANGLE']),
        90 - float(md['MEAN_SUN_ZENITH_ANGLE']), -5, 40)[crop]
    if not np.array_equal(got['SHAD'], shad_host.astype(np.uint8)):
        bad = np.argwhere(got['SHAD'] != shad_host)
        raise AssertionError(f'SHAD differs from the host shadow in '
                             f'{len(bad)} px, first at {bad[:8].tolist()}')
    for layer in ('LAND', 'SHAD'):
        vals, counts = np.unique(got[layer], return_counts=True)
        say(f'  {layer} classes: {dict(zip(vals.tolist(), counts.tolist()))}')
    say('run c: WTR, BWTR, CONF, DIAG, WTR-1, WTR-2, CLOUD == oracle; DEM '
        '== host warp; SHAD == host shadow (bit for bit)')
    _sqrt_on_the_card(torch)

    # (a) int16, 'cover' (K1 + K2), ocean masking
    count(_run_cli(torch, 'a (int16, cover, ocean)', [rc['a']],
                   ('wtr_k1', 'wtr_k2')))
    got = _read_layers(os.path.join(workdir, 'output_a'))
    ocean = create_ocean_mask(shoreline, 1, workdir, synthetic.geotransform(),
                              CRS.from_epsg(synthetic.EPSG).to_wkt(), SIZE,
                              SIZE)
    wrong = int(((got['WTR-1'] == 254) != ((ocean == 0) & ~invalid)).sum())
    if wrong:
        raise AssertionError(f'run a: the ocean of WTR-1 differs from the '
                             f'host ocean mask (distance transform) in '
                             f'{wrong} px')
    share = float((ocean == 0).mean())
    if ocean[:, :int(0.6 * SIZE)].min() == 0 or not 0.35 < share < 0.40:
        raise AssertionError(f'ocean share {share} (the shoreline leaves '
                             'the east 40% ocean, less a 1 km buffer)')
    _hold_against_oracle(oracle, 'a', got, ints, fmask_a, invalid, 'cover',
                         ocean=ocean)
    _hold_coverage('a', os.path.join(workdir, 'output_a'), fmask_a, invalid,
                   'cover', ocean)
    cloud = got['CLOUD']
    ignore = np.where(cloud == 255, 255,
                      (cloud & 0xFD) | 2 * ((fmask_a & 16) != 0))
    changed = int((cloud != ignore).sum())
    if changed == 0:
        raise AssertionError("run a: 'cover' changed no CLOUD pixel")
    say(f"run a: all layers == oracle (scipy dilations); ocean == host "
        f"ocean mask, {share:.2%} of the tile; 'cover' changed {changed} "
        f"CLOUD px against 'ignore'")

    # (b) --offset-and-scale-inputs (K3), the cast of
    # proteus_tpu_torch/io/hls.py:176
    count(_run_cli(torch, 'b (float32 scaled, mask)',
                   [rc['b'], '--offset-and-scale-inputs'], ('wtr_k3',)))
    got = _read_layers(os.path.join(workdir, 'output_b'))
    scale, offset = float(md['scale_factor']), float(md['add_offset'])
    scaled = {k: scale * (np.asarray(v, dtype=np.float32) - offset)
              for k, v in ints.items()}
    _hold_against_oracle(oracle, 'b', got, scaled, raw['Fmask'], invalid,
                         'mask')
    _hold_coverage('b', os.path.join(workdir, 'output_b'), raw['Fmask'],
                   invalid, 'mask')
    say('run b: all layers == oracle on the float32 bands (bit for bit)')
    tile = dict(files=files, raw=raw, ints=ints, invalid=invalid,
                input_dir=input_dir, input_a=input_a, fmask_a=fmask_a,
                ocean=ocean, dem_file=dem_file, lc_file=lc_file,
                wc_file=wc_file, shoreline=shoreline, dem_host=dem_host)
    return launches, tile


# peak device memory of each campaign when the warp was eager PyTorch
# (PERF.md section 5; NVIDIA H100 80GB HBM3, 700.00 W)
EAGER_WARP_PEAK_GIB = {'d': 8.997, 'e': 8.997, 'f': 9.009, 'g': 9.009, 'h': 11.011,
                'cold': 24.72, 'warm': 9.01}


def _fresh_campaign(torch):
    """A cold ancillary and payload cache, the stage times, the peak device
    memory and the launch counts set to 0, just before a campaign."""
    from proteus_tpu_torch.io.cog import PAYLOAD_CACHE
    from proteus_tpu_torch.parallel import campaign

    campaign.ANCILLARY_CACHE.clear()
    PAYLOAD_CACHE.clear()
    campaign.STAGE_TIMES.reset()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    return time.perf_counter()


def _campaign_done(torch, label, t0, stats, expect, n_tiles, eager=None):
    """The counts just after a campaign: checks that its tiles are done
    and each slice in ``expect`` launched; prints its wall, its peak device
    memory (beside ``eager``, the same campaign's with the eager warp) and
    stage core-seconds; returns the counts."""
    wall = time.perf_counter() - t0
    launches = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    if stats['tiles_done'] != n_tiles or stats['tiles_failed']:
        raise AssertionError(f'campaign {label}: {stats}')
    for name in expect:
        if launches[name] < 1:
            raise AssertionError(f'campaign {label} never launched {name}')
    say(f'campaign {label}: {wall:.2f} s wall for {n_tiles} tiles, '
        f'{wall / n_tiles:.2f} s/tile, launches {launches}, peak device memory '
        f'{peak / 2**30:.3f} GiB'
        + (f' (with the eager warp: {eager} GiB)' if eager else '')
        + '; stage core-seconds (summed over pool threads):')
    for name, entry in stats['stage_seconds'].items():
        say(f'    {name:<28} {entry["seconds"]:8.2f} s  {entry["calls"]:3d}'
            f' calls')
    return launches


def _run_campaign(torch, label, argv, expect, stats_path, n_tiles=3,
                  eager=None):
    """One campaign through the campaign CLI's ``main`` with the launch
    counts set to 0 just before it and a cold ancillary cache; checks that
    each slice in ``expect`` launched and returns the counts."""
    from proteus_tpu_torch.cli.dswx_campaign import main as campaign_main

    t0 = _fresh_campaign(torch)
    try:
        campaign_main(argv + ['--stats-json', stats_path])
    except SystemExit as exc:
        raise AssertionError(f'campaign {label} exited with {exc.code}')
    finally:
        # the CLI routes stdout/stderr into its logger
        sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
    with open(stats_path) as fh:
        stats = json.load(fh)
    return _campaign_done(torch, label, t0, stats, expect, n_tiles, eager)


def _same_products(label, got, want, layers):
    import numpy as np
    for layer in layers:
        if not np.array_equal(got[layer], want[layer], equal_nan=True):
            raise AssertionError(
                f'campaign {label}: {layer} differs in '
                f'{int((got[layer] != want[layer]).sum())} px')


def phase_campaign(torch, workdir, tile):
    import shutil
    import numpy as np
    oracle = _load_oracle()
    from proteus_tpu_torch.testing import synthetic

    say('== phase 5: three campaigns through the campaign CLI, 3 full-size '
        'tiles each (A, B, a copy of A), 2 tiles a device')
    t0 = time.perf_counter()
    tile_b = os.path.join(workdir, 'tile_b')
    _, raw_b = synthetic.make_hls_v2_dataset(tile_b, size=SIZE, seed=12)
    copies = {}
    for name, src in (('tile_a2', tile['input_dir']),
                      ('tile_fa2', tile['input_a'])):
        copies[name] = os.path.join(workdir, name)
        shutil.copytree(src, copies[name])
    invalid_b = np.zeros((SIZE, SIZE), bool)
    ints_b = {}
    for key, name in [('blue', 'B02'), ('green', 'B03'), ('red', 'B04'),
                      ('nir', 'B8A'), ('swir1', 'B11'), ('swir2', 'B12')]:
        invalid_b |= raw_b[name] == -9999
        ints_b[key] = np.clip(raw_b[name], 1, None)
    say(f'tile B and the copies written in {time.perf_counter() - t0:.1f} s')

    layers = ['WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'LAND',
              'SHAD', 'CLOUD', 'DEM', 'BROWSE']
    anc = ['--dem', tile['dem_file'], '-c', tile['lc_file'], '-w',
           tile['wc_file'], '--browse', '--tiles-per-device', '2',
           '--product-version', '0.1']
    md = synthetic.HLS_METADATA
    scale, offset = float(md['scale_factor']), float(md['add_offset'])
    launches = {}
    for label, dirs, extra, expect, single, mode in (
            ('d (int16, mask)',
             [tile['input_dir'], tile_b, copies['tile_a2']], [],
             ('wtr_k1', 'wtr_k5', 'wtr_k6'), 'output_c', 'mask'),
            ('e (scaled, device scale)',
             [tile['input_dir'], tile_b, copies['tile_a2']], ['--scaled'],
             ('wtr_k3', 'wtr_k4', 'wtr_k5', 'wtr_k6'), 'output_b', 'mask'),
            ('f (int16, cover, shoreline)',
             [tile['input_a'], tile_b, copies['tile_fa2']],
             ['--mask-adjacent-to-cloud-mode', 'cover', '-s',
              tile['shoreline']],
             ('wtr_k1', 'wtr_k2', 'wtr_k5', 'wtr_k6'), 'output_a',
             'cover')):
        key = label[0]
        out = os.path.join(workdir, f'campaign_{key}')
        stats_path = os.path.join(workdir, f'stats_{key}.json')
        run = _run_campaign(torch, label, dirs + ['-o', out] + anc + extra,
                            expect, stats_path,
                            eager=EAGER_WARP_PEAK_GIB[key])
        for name, n in run.items():
            launches[name] = launches.get(name, 0) + n
        names = [os.path.basename(d) for d in dirs]
        got_a = _read_layers(os.path.join(out, names[0]), names[0])
        _same_products(label, got_a, _read_layers(os.path.join(
            workdir, single)), layers)
        _same_products(label, _read_layers(os.path.join(out, names[2]),
                                           names[2]), got_a, layers)
        got_b = _read_layers(os.path.join(out, names[1]), names[1])
        bands_b = ints_b
        if key == 'e':
            bands_b = {k: scale * (np.asarray(v, dtype=np.float32) - offset)
                       for k, v in ints_b.items()}
        ocean = tile['ocean'] if key == 'f' else None
        _hold_against_oracle(oracle, f'{key} tile B', got_b, bands_b,
                             raw_b['Fmask'], invalid_b, mode, ocean=ocean)
        # the totals: valid pixels not ocean either (the data-parallel
        # rule, campaign.py:218-231); tiles A, B and A's copy
        fmask_a = tile['fmask_a'] if key == 'f' else tile['raw']['Fmask']
        counts = [_host_counts(fm, inv, mode, ocean) for fm, inv in (
            (fmask_a, tile['invalid']), (raw_b['Fmask'], invalid_b),
            (fmask_a, tile['invalid']))]
        want = {'n_valid_total': sum(c[0] for c in counts),
                'n_cloud_and_valid_total': sum(c[1] for c in counts)}
        with open(stats_path) as fh:
            stats = json.load(fh)
        got = {k: stats[k] for k in want}
        if got != want:
            raise AssertionError(f'campaign {key}: totals {got}, the host '
                                 f'counts give {want}')
        say(f'campaign {key}: tile A == single-tile run '
            f'{single[-1]} on all 11 layers (WTR ... DEM, BROWSE), its copy '
            f'== tile A; tile B == oracle on WTR, BWTR, CONF, DIAG, WTR-1, '
            f'WTR-2, CLOUD (bit for bit); totals {got} == the host counts')
    return launches, dict(tile_b=tile_b, fmask_b=raw_b['Fmask'],
                          invalid_b=invalid_b, copies=copies)


LAYERS = ['WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'LAND', 'SHAD',
          'CLOUD', 'DEM', 'BROWSE']


def _same_bytes(label, want_dir, got_dir):
    """Every product file (COG and PNG) of ``want_dir`` byte-identical in
    ``got_dir`` but for the products' processing time; returns the number
    of files."""
    import glob
    import re
    stamp = re.compile(rb'PROCESSING_DATETIME">[^<]*<')
    want = sorted(glob.glob(os.path.join(want_dir, '*', '*.tif'))
                  + glob.glob(os.path.join(want_dir, '*', '*.png')))
    for wf in want:
        gf = os.path.join(got_dir, os.path.relpath(wf, want_dir))
        with open(wf, 'rb') as a, open(gf, 'rb') as b:
            if stamp.sub(b'', a.read()) != stamp.sub(b'', b.read()):
                raise AssertionError(f'campaign {label}: {gf} differs from '
                                     f'{wf}')
    return len(want)


def _spatial_totals(fmasks, invalids, mode):
    """The campaign totals by the reference's spatial rule
    (proteus_tpu/parallel/campaign.py:441-452), on the host: valid =
    ~invalid (no ocean term), cloudy = preliminary CLOUD != 0."""
    counts = [_host_counts(fm, inv, mode) for fm, inv in zip(fmasks,
                                                             invalids)]
    return {'n_valid_total': sum(c[0] for c in counts),
            'n_cloud_and_valid_total': sum(c[1] for c in counts)}


def _run_runner(torch, label, runner, jobs, expect):
    """One campaign through ``CampaignRunner.run`` with the launch counts
    set to 0 just before it; returns the counts and the stats."""
    t0 = _fresh_campaign(torch)
    stats = runner.run(jobs)
    return _campaign_done(torch, label, t0, stats, expect, len(jobs),
                          EAGER_WARP_PEAK_GIB[label[0]]), stats


def phase_spatial_campaign(torch, workdir, tile, ctx):
    """Campaigns (f) and (e) again through CampaignRunner with each tile's
    rows cut over a 1 x 4 mesh of card 0 (K6 spatial): (g) 'cover' with
    the shoreline, (h) scaled with the device cast. Their product files
    == (f)'s and (e)'s, byte for byte but the processing time; their
    totals == the reference's spatial rule on the host."""
    import glob
    from proteus_tpu_torch.core.thresholds import HlsThresholds
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.parallel.campaign import CampaignRunner, TileJob

    say(f'== phase 5c: two spatial campaigns through CampaignRunner, 3 '
        f'full-size tiles each, {SHARDS} row shards a tile on card 0')
    mesh = [torch.device(DEVICE, 0)] * SHARDS
    fmask_a, fmask_b = tile['fmask_a'], ctx['fmask_b']
    launches = {}
    for label, dirs, fmasks, mode, extra, expect, like in (
            ('g (int16, cover, shoreline; spatial)',
             [tile['input_a'], ctx['tile_b'], ctx['copies']['tile_fa2']],
             [fmask_a, fmask_b, fmask_a], 'cover',
             dict(shoreline_shapefile=tile['shoreline']),
             ('wtr_k1', 'wtr_k2', 'wtr_k6', 'wtr_k6_spatial'), 'f'),
            ('h (scaled, device scale; spatial)',
             [tile['input_dir'], ctx['tile_b'], ctx['copies']['tile_a2']],
             [tile['raw']['Fmask'], fmask_b, tile['raw']['Fmask']], 'mask',
             {}, ('wtr_k3', 'wtr_k4', 'wtr_k6', 'wtr_k6_spatial'), 'e')):
        key = label[0]
        out = os.path.join(workdir, f'campaign_{key}')
        names = [os.path.basename(d) for d in dirs]
        jobs = [TileJob(n, sorted(glob.glob(os.path.join(d, '*.tif'))),
                        os.path.join(out, n), product_id=n,
                        product_version='0.1', dem_file=tile['dem_file'],
                        landcover_file=tile['lc_file'],
                        worldcover_file=tile['wc_file'], **extra)
                for n, d in zip(names, dirs)]
        cfg = DswxChainConfig(thresholds=HlsThresholds(),
                              mask_adjacent_to_cloud_mode=mode,
                              shadow_masking_algorithm='sun_local_inc_angle')
        runner = CampaignRunner(config=cfg, mesh=mesh, save_browse=True,
                                spatial_shards=SHARDS, tiles_per_device=2,
                                scaled_inputs=key == 'h')
        if key == 'h' and not runner.device_scale:
            raise AssertionError('campaign h: the device cast is off')
        run, stats = _run_runner(torch, label, runner, jobs, expect)
        for name, n in run.items():
            launches[name] = launches.get(name, 0) + n
        want_dir = os.path.join(workdir, f'campaign_{like}')
        for n in names:
            _same_products(f'{key} {n}', _read_layers(os.path.join(out, n),
                                                      n),
                           _read_layers(os.path.join(want_dir, n), n), LAYERS)
        n_files = _same_bytes(key, want_dir, out)
        want = _spatial_totals(fmasks, [tile['invalid'], ctx['invalid_b'],
                                        tile['invalid']], mode)
        got = {k: stats[k] for k in want}
        if got != want:
            raise AssertionError(f'campaign {key}: totals {got}, the spatial '
                                 f'rule gives {want}')
        say(f'campaign {key}: {n_files} product files == campaign {like}\'s '
            f'byte for byte (but the processing time); totals {got} == the '
            f'spatial rule (valid = ~invalid, no ocean term)')
    return launches


def phase_step_sweep(torch, tile, workdir):
    """The campaign step alone (K1+K5+K6 and the coverage counts, the
    totals read back) on device-resident copies of tile A at 1, 2, 4 and 8
    tiles a device: the per-tile device time that sets the default
    tiles_per_device on this card."""
    import numpy as np
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.parallel.campaign import make_campaign_step

    say('== phase 5b: the campaign step alone at 1, 2, 4 and 8 tiles a '
        'device')
    device = torch.device(DEVICE)
    got = _read_layers(os.path.join(workdir, 'output_c'))
    planes = [tile['ints'][k] for k in ('blue', 'green', 'red', 'nir',
                                        'swir1', 'swir2')]
    planes += [tile['raw']['Fmask'], tile['invalid'], got['SHAD'],
               got['LAND']]
    planes = [torch.from_numpy(np.ascontiguousarray(p)).to(device)
              for p in planes]
    step = make_campaign_step(DswxChainConfig(), [device], with_shadow=True,
                              with_landcover=True)
    for tpd in (1, 2, 4, 8):
        args = [[torch.stack([p] * tpd)] for p in planes]
        step(*args)
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(10):
                step(*args)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) / (10 * tpd) * 1e3)
        say(f'campaign step, {tpd} tile(s) a device: '
            f'{statistics.median(runs):.4f} ms/tile (runs {runs}; host clock'
            f' around 10 steps, each reading its totals back)')
        del args


MULTI_SIZE = 1024  # tile side of the multi-card check


def phase_multi_gpu(torch, workdir):
    """The campaign CLI over every visible card against the same campaign
    on card 0 alone, file by file: six jobs (three tiles, each twice) at
    MULTI_SIZE with DEM, CGLS, WorldCover and browse, one tile a card, in
    phase 5's three modes. Every card must have run its share (its launch
    counts, its peak memory), and the multi-card run's tiles are held
    against the oracle."""
    import shutil
    import numpy as np
    oracle = _load_oracle()
    from proteus_tpu_torch.geo.crs import CRS
    from proteus_tpu_torch.geo.polygon import create_ocean_mask
    from proteus_tpu_torch.testing import synthetic

    n_cards = torch.cuda.device_count()
    size = MULTI_SIZE
    say(f'== phase 6: the campaign over {n_cards} cards against card 0 '
        f'alone, 6 jobs of {size}^2, one tile a card')
    t0 = time.perf_counter()
    dirs, bands, fmasks, invalids = [], [], [], []
    for t in range(3):
        d = os.path.join(workdir, f'multi_{t}')
        _, raw = synthetic.make_hls_v2_dataset(d, size=size, seed=60 + t)
        dirs.append(d)
        inv = np.zeros((size, size), bool)
        ints = {}
        for key, name in [('blue', 'B02'), ('green', 'B03'),
                          ('red', 'B04'), ('nir', 'B8A'), ('swir1', 'B11'),
                          ('swir2', 'B12')]:
            inv |= raw[name] == -9999
            ints[key] = np.clip(raw[name], 1, None)
        bands.append(ints)
        fmasks.append(raw['Fmask'])
        invalids.append(inv)
    for t in range(3):
        dirs.append(os.path.join(workdir, f'multi_{t}_copy'))
        shutil.copytree(dirs[t], dirs[-1])
    anc_dir = os.path.join(workdir, 'multi_anc')
    os.makedirs(anc_dir)
    anc = ['--dem', synthetic.make_dem(anc_dir, size=size),
           '-c', synthetic.make_landcover(anc_dir, size=size),
           '-w', synthetic.make_worldcover(anc_dir, size=size), '--browse',
           '--tiles-per-device', '1', '--product-version', '0.1']
    shoreline = synthetic.make_shoreline(anc_dir, size=size)
    host_ocean = create_ocean_mask(
        shoreline, 1, anc_dir, synthetic.geotransform(),
        CRS.from_epsg(synthetic.EPSG).to_wkt(), size, size)
    say(f'tiles written in {time.perf_counter() - t0:.1f} s')

    md = synthetic.HLS_METADATA
    scale, offset = float(md['scale_factor']), float(md['add_offset'])
    layers = ['WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'LAND',
              'SHAD', 'CLOUD', 'DEM', 'BROWSE']
    names = [os.path.basename(d) for d in dirs]
    # 6 jobs over n cards: ceil(6 / n) batches, each launching on every card
    batches = -(-len(dirs) // n_cards)
    for label, extra, expect, mode in (
            ('d (int16, mask)', [], ('wtr_k1', 'wtr_k5', 'wtr_k6'), 'mask'),
            ('e (scaled, device scale)', ['--scaled'],
             ('wtr_k3', 'wtr_k4', 'wtr_k5', 'wtr_k6'), 'mask'),
            ('f (int16, cover, shoreline)',
             ['--mask-adjacent-to-cloud-mode', 'cover', '-s', shoreline],
             ('wtr_k1', 'wtr_k2', 'wtr_k5', 'wtr_k6'), 'cover')):
        key = label[0]
        outs = {}
        for devices in ('cuda', 'cuda:0'):
            os.environ['PROTEUS_TPU_TORCH_DEVICE'] = devices
            out = os.path.join(workdir, f'multi_{key}_{devices[-1]}')
            for k in range(n_cards):
                torch.cuda.reset_peak_memory_stats(k)
            launches = _run_campaign(
                torch, f'{key} on {devices}', dirs + ['-o', out] + anc + extra,
                expect, os.path.join(workdir, f'multi_stats_{key}.json'),
                n_tiles=len(dirs))
            if devices == 'cuda':
                peaks = [torch.cuda.max_memory_allocated(k)
                         for k in range(n_cards)]
                if min(peaks) == 0:
                    raise AssertionError(f'campaign {key}: a card ran nothing'
                                         f' (peak bytes {peaks})')
                for name in expect:
                    # in 'cover' both passes count K5 and K6
                    calls = 2 if mode == 'cover' and name in (
                        'wtr_k5', 'wtr_k6') else 1
                    if launches[name] != calls * batches * n_cards:
                        raise AssertionError(
                            f'campaign {key}: {name} launched '
                            f'{launches[name]} times, not {calls} a card a '
                            f'batch ({calls * batches * n_cards})')
                say(f'  peak device memory a card, GiB: '
                    f'{[round(p / 2**30, 3) for p in peaks]}')
            outs[devices] = {n: _read_layers(os.path.join(out, n), n)
                             for n in names}
        # each tile's rows over 2 and over 4 cards (--spatial-shards): full
        # outputs, K6 spatial, the same products as card 0 alone
        os.environ['PROTEUS_TPU_TORCH_DEVICE'] = 'cuda'
        for shards in (2, 4):
            if n_cards % shards:
                continue
            out = os.path.join(workdir, f'multi_{key}_sp{shards}')
            for k in range(n_cards):
                torch.cuda.reset_peak_memory_stats(k)
            _run_campaign(
                torch, f'{key} on {n_cards} cards, --spatial-shards {shards}',
                dirs + ['-o', out, '--spatial-shards', str(shards)] + anc
                + extra, tuple(n for n in expect if n != 'wtr_k5')
                + ('wtr_k6_spatial',),
                os.path.join(workdir, f'multi_stats_{key}.json'),
                n_tiles=len(dirs))
            peaks = [torch.cuda.max_memory_allocated(k)
                     for k in range(n_cards)]
            if min(peaks) == 0:
                raise AssertionError(f'campaign {key}, {shards} shards: a '
                                     f'card ran nothing (peak bytes {peaks})')
            say(f'  peak device memory a card, GiB: '
                f'{[round(p / 2**30, 3) for p in peaks]}')
            for n in names:
                _same_products(f'{key} {n}, {shards} shards',
                               _read_layers(os.path.join(out, n), n),
                               outs['cuda:0'][n], layers)
            say(f'campaign {key}, --spatial-shards {shards}: == card 0 alone '
                f'on all 11 layers of 6 jobs')
        for n in names:
            _same_products(f'{key} {n}', outs['cuda'][n], outs['cuda:0'][n],
                           layers)
        for t in range(3):
            got = outs['cuda'][names[t]]
            _same_products(f'{key} copy of {names[t]}',
                           outs['cuda'][names[t + 3]], got, layers)
            tile_bands = bands[t]
            if key == 'e':
                tile_bands = {k: scale * (np.asarray(v, dtype=np.float32)
                                          - offset)
                              for k, v in tile_bands.items()}
            ocean = host_ocean if key == 'f' else None
            _hold_against_oracle(oracle, f'{key} {names[t]} (multi-card)',
                                 got, tile_bands, fmasks[t], invalids[t],
                                 mode, ocean=ocean)
        say(f'campaign {key}: {n_cards} cards == card 0 alone on all 11 '
            f'layers of 6 jobs; the copies == their tiles; tiles == oracle '
            f'(bit for bit)')
    os.environ['PROTEUS_TPU_TORCH_DEVICE'] = DEVICE


PROFILE_VARIANTS = ('floor_int16_inputs', 'floor_f32_inputs', 'int_full',
                    'int_minimal_packed', 'int_full_cover', 'scaled_full',
                    'scaled_minimal_packed', 'plain_chain')


def _default_runconfig(workdir, tile, label, **extra):
    """A runconfig of the default run on tile A with its own output
    directory ``output_<label>``."""
    from proteus_tpu_torch.testing import synthetic
    return synthetic.write_runconfig(
        os.path.join(workdir, f'rc_{label}.yaml'), tile['input_dir'],
        os.path.join(workdir, f'output_{label}'),
        os.path.join(workdir, f'scratch_{label}'),
        dem_file=tile['dem_file'], landcover_file=tile['lc_file'],
        worldcover_file=tile['wc_file'], check_coverage=True, **extra)


def _short(name):
    """A device operation's name without its argument list."""
    return name.split('(')[0]


def phase_profile(torch, workdir, tile):
    """The kernel-profile twin at full size through its ``main`` (the null
    kernel's caller: the launch counts start at 0 just before it), the
    bench twin once, and the default single-tile run again under
    ``PROTEUS_TPU_TRACE_DIR``: the device's busy and idle share over the
    device-chain stage, and the traced run's layers against run (c)'s."""
    import glob
    from proteus_tpu_torch.ops import null_kernel, wtr_kernel
    from proteus_tpu_torch.runtime.profiling import device_busy_share
    from proteus_tpu_torch.tools import bench, kernel_profile

    say(f'== phase 7: the kernel-profile tool at {SIZE}x{SIZE}, the bench '
        f'twin, and a traced default run')
    _reset_counts()
    null_kernel.LAUNCHES['null'] = 0
    out = os.path.join(workdir, 'kernel_profile.json')
    # 16 launches a pass: with the tool's default of 4 the first launch's
    # start-up is a sixth of the null kernel's pass
    rc = kernel_profile.main(['--size', str(SIZE), '--device', DEVICE,
                              '--iters', '16', '--out', out, '--trace-dir',
                              os.path.join(workdir, 'trace_profile')])
    launches = {**_read_counts(), **null_kernel.LAUNCHES}
    if rc != 0:
        raise AssertionError(f'kernel_profile exited with {rc}')
    with open(out) as fh:
        prof = json.load(fh)
    if tuple(prof['variants']) != PROFILE_VARIANTS:
        raise AssertionError(f'kernel_profile variants: '
                             f'{tuple(prof["variants"])}')
    for name in ('null', 'wtr_k1', 'wtr_k2', 'wtr_k3', 'wtr_k5', 'wtr_k6'):
        if launches[name] < 1:
            raise AssertionError(f'kernel_profile never launched {name}')
    say(f'kernel_profile on {prof["device"]} ({prof["timer"]}, '
        f'{prof["iters"]} launches a pass, median of {prof["passes"]}), '
        f'launches {launches}:')
    for name, v in prof['variants'].items():
        say(f'    {name:<24} {v["s_per_tile"] * 1e3:9.4f} ms/tile  '
            f'{v["effective_gbps"]:8.1f} GB/s  ({v["hbm_in_mb"]} MB in, '
            f'{v["hbm_out_mb"]} MB out)')
    say(f'    attribution, 1 - floor / variant: '
        f'{prof["attribution"]["compute_share"]}; '
        f'{prof["attribution"]["conclusion"]}')
    if 'trace_busy' in prof:
        busy = prof['trace_busy']
        say(f'    trace of one int_minimal_packed launch: device busy '
            f'{busy["busy_s"] * 1e3:.4f} ms of {busy["window_s"] * 1e3:.4f} '
            f'ms; operations '
            f'{[(_short(n), round(t * 1e3, 4), c) for n, t, c in busy["top"]]}')

    wtr_kernel.LAUNCHES['wtr_k6'] = 0
    if bench.main(['--size', str(SIZE), '--iters', '2', '--passes', '2',
                   '--device', DEVICE]) != 0:
        raise AssertionError('the bench twin failed')
    launches['wtr_k6'] += wtr_kernel.LAUNCHES['wtr_k6']

    # the default run again, traced
    trace_dir = os.path.join(workdir, 'trace_run')
    os.environ['PROTEUS_TPU_TRACE_DIR'] = trace_dir
    try:
        run = _run_cli(torch, 't (default, traced)',
                       [_default_runconfig(workdir, tile, 't')], ('wtr_k1',))
    finally:
        del os.environ['PROTEUS_TPU_TRACE_DIR']
    for name, n in run.items():
        launches[name] = launches.get(name, 0) + n
    _same_products('t (traced)', _read_layers(os.path.join(workdir,
                                                           'output_t')),
                   _read_layers(os.path.join(workdir, 'output_c')), LAYERS)
    traces = glob.glob(os.path.join(trace_dir, '*.json'))
    if len(traces) != 1:
        raise AssertionError(f'expected one trace in {trace_dir}: {traces}')
    busy = device_busy_share(traces[0], window='device chain (compile+run)')
    hand = [_short(n) for n, _, _ in busy['top'] if 'wtr_pixel_kernel' in n]
    say(f'run t: all 11 layers == run c; trace {os.path.getsize(traces[0])} '
        f'bytes; over the device-chain stage ({busy["window_s"] * 1e3:.3f} '
        f'ms) the device was busy {busy["busy_s"] * 1e3:.3f} ms '
        f'({busy["busy_share"]:.2%}) and idle {busy["idle_s"] * 1e3:.3f} ms '
        f'({busy["idle_share"]:.2%}), {busy["n_device_operations"]} device '
        f'operations; the hand kernel in the trace: {hand or "MISSING"}')
    for name, seconds, count in busy['top']:
        say(f'    {seconds * 1e3:9.4f} ms  {count:4d} x  {name[:100]}')
    whole = device_busy_share(traces[0])
    say(f'  whole trace (device chain + device->host transfer, first to '
        f'last device operation): busy {whole["busy_s"] * 1e3:.3f} ms of '
        f'{whole["window_s"] * 1e3:.3f} ms ({whole["busy_share"]:.2%})')
    return launches


def terrains(size):
    """The four DEMs of tools/hillshade_tpu_parity.py:29-40: a smooth
    random surface, a noisy 6000 m plateau (the worst float32
    cancellation), the smooth one with 5% NaN holes, a quadratic sweep."""
    import numpy as np
    rng = np.random.default_rng(20260818)
    base = rng.normal(0, 1, (size, size)).cumsum(0).cumsum(1)
    smooth = (base / np.abs(base).max() * 800 + 200).astype(np.float32)
    plateau = (6000.0 + rng.normal(0, 2.0, (size, size))).astype(np.float32)
    holed = smooth.copy()
    holed[rng.random((size, size)) < 0.05] = np.nan
    col = np.arange(size, dtype=np.float64)
    sweep = np.tile((0.002 * col ** 2).astype(np.float32), (size, 1))
    return {'smooth': smooth, 'plateau_6000m': plateau,
            'nan_holed': holed, 'quadratic_sweep': sweep}


def _host_otsu_mask(sh, dem, az, elev, psx, psy):
    """The otsu shadow mask by the host's float64 chain: the hillshade
    oracle, its histogram, the reference's threshold, ``>``."""
    import numpy as np
    hs = sh._host_hillshade_gdal(dem, az, elev, psx, psy)
    threshold = sh._otsu_threshold_f64(np.bincount(hs.ravel(),
                                                   minlength=256))
    return hs, hs > threshold


def phase_otsu_and_s2(torch, workdir, tile):
    """The otsu hillshade on the card against the host float64 oracle at
    full size, an otsu product run through the CLI, and a raw 10 m
    Sentinel-2 band through the ingest's resample hook on the card."""
    import numpy as np
    oracle = _load_oracle()
    from proteus_tpu_torch.io import hls as hls_io
    from proteus_tpu_torch.io.cog import write_cog
    from proteus_tpu_torch.models.dswx import shadow as sh
    from proteus_tpu_torch.testing import synthetic

    size = SIZE + 100  # the tile with its 50 px DEM margin
    say(f'== phase 8: the otsu hillshade at {size}x{size} on four terrains '
        f'vs the host float64 oracle; an otsu run; a 10 m band ingest')
    device = torch.device(DEVICE)
    geoms = {'smooth': (135.0, 45.0, -30.0),
             'plateau_6000m': (277.3, 18.0, -30.0),
             'nan_holed': (80.0, 70.0, 30.0),
             'quadratic_sweep': (135.0, 45.0, -30.0)}
    for name, dem in terrains(size).items():
        az, elev, psy = geoms[name]
        t0 = time.perf_counter()
        want, want_mask = _host_otsu_mask(sh, dem, az, elev, 30.0, psy)
        t_host = time.perf_counter() - t0
        dem_d = torch.from_numpy(dem).to(device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, n_band = sh.compute_hillshade_exact(dem_d, az, elev, 30.0, psy,
                                                 return_band=True)
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        mask = sh.compute_otsu_shadow_layer_exact(dem_d, az, elev, 30.0, psy)
        mism = int((got.cpu().numpy() != want).sum())
        mask_mism = int((mask.cpu().numpy() != want_mask).sum())
        say(f'  {name} (azimuth {az}, elevation {elev}, spacing 30 x {psy}):'
            f' {mism} of {want.size} hillshade bytes and {mask_mism} otsu '
            f'mask px differ from the host oracle; the host decided '
            f'{n_band} px of the uncertainty band; device {t_dev:.3f} s '
            f'(with the band), host oracle {t_host:.2f} s; not-shadow share '
            f'{float(want_mask.mean()):.4f}')
        if mism or mask_mism:
            raise AssertionError(f'otsu hillshade, {name}: {mism} bytes, '
                                 f'{mask_mism} mask px differ')
        del dem_d, got, mask

    # a product run with the otsu shadow through the CLI
    launches = _run_cli(torch, 'o (default, otsu shadow)', [
        _default_runconfig(workdir, tile, 'o', extra_processing={
            'shadow_masking_algorithm': 'otsu'})], ('wtr_k1',))
    got = _read_layers(os.path.join(workdir, 'output_o'))
    md = synthetic.HLS_METADATA
    gt = synthetic.geotransform()
    _, shad_host = _host_otsu_mask(
        sh, tile['dem_host'], float(md['MEAN_SUN_AZIMUTH_ANGLE']),
        90 - float(md['MEAN_SUN_ZENITH_ANGLE']), gt[1], gt[5])
    shad_host = shad_host[50:-50, 50:-50]
    if not np.array_equal(got['SHAD'], shad_host.astype(np.uint8)):
        raise AssertionError(
            f'run o: SHAD differs from the host otsu chain in '
            f'{int((got["SHAD"] != shad_host).sum())} px')
    _hold_against_oracle(oracle, 'o', got, tile['ints'],
                         tile['raw']['Fmask'], tile['invalid'], 'mask')
    vals, counts = np.unique(got['SHAD'], return_counts=True)
    say(f'run o: SHAD == the host otsu chain on the host-warped DEM (bit '
        f'for bit), classes {dict(zip(vals.tolist(), counts.tolist()))}; '
        f'the other layers == oracle')

    # a raw 10 m band, 3 x SIZE px a side, through the ingest on the card
    n = 3 * SIZE
    rng = np.random.default_rng(20261019)
    band = rng.integers(-200, 12000, (n, n), dtype=np.int16)
    band[::97, ::89] = -9999
    path = os.path.join(workdir, 'S2.T15SXS.B02.tif')
    t0 = time.perf_counter()
    write_cog(path, band, geotransform=(gt[0], 10.0, 0.0, gt[3], 0.0, -10.0),
              epsg=synthetic.EPSG, nodata=-9999,
              metadata=dict(synthetic.HLS_METADATA), overview_levels=())
    t_write = time.perf_counter() - t0
    image_dict = {}
    t0 = time.perf_counter()
    ok = hls_io.load_hls_band(path, image_dict, {}, {}, {}, 'blue', False,
                              device=device)
    t_load = time.perf_counter() - t0
    if ok is not True:
        raise AssertionError(f'10 m ingest: load_hls_band returned {ok!r}')
    fill = band == -9999
    sums = np.where(fill, 0, band).astype(np.int32).reshape(
        SIZE, 3, SIZE, 3).sum(axis=(1, 3))
    want = np.rint(sums / 9.0).astype(np.int16)
    fill30 = fill.reshape(SIZE, 3, SIZE, 3).any(axis=(1, 3))
    want = np.clip(np.where(fill30, 1, want), 1, None)
    if not np.array_equal(image_dict['blue'], want):
        raise AssertionError(
            f'10 m ingest: the 30 m band differs from the numpy 3 x 3 mean '
            f'in {int((image_dict["blue"] != want).sum())} px')
    if not np.array_equal(image_dict['invalid_ind_array'], fill30):
        raise AssertionError('10 m ingest: the invalid mask differs')
    gt30 = image_dict['geotransform']
    if (gt30[1], gt30[5]) != (30.0, -30.0) or image_dict['length'] != SIZE:
        raise AssertionError(f'10 m ingest: grid {gt30}')
    say(f'10 m ingest: a {n}x{n} int16 band (written in {t_write:.2f} s) '
        f'read and resampled on {device} in {t_load:.2f} s == rint of the '
        f'numpy float64 3 x 3 mean, {int(fill30.sum())} fill px kept, grid '
        f'30 x -30 m')
    return launches


def phase_inexact_run(torch, workdir, tile):
    """The default single-tile run on the card with thresholds that are no
    exact rationals (run p): K1 launches as in run (c), and the layers
    equal the numpy oracle (float64 on the integer bands)."""
    oracle = _load_oracle()
    import numpy as np

    say('== phase 4b: a run with inexact int16-band thresholds on the card')
    launches = _run_cli(
        torch, 'p (default, inexact thresholds)',
        [_default_runconfig(workdir, tile, 'p',
                            thresholds=INEXACT_THRESHOLDS)], ('wtr_k1',))
    got = _read_layers(os.path.join(workdir, 'output_p'))
    _hold_against_oracle(oracle, 'p', got, tile['ints'], tile['raw']['Fmask'],
                         tile['invalid'], 'mask',
                         thresholds=INEXACT_THRESHOLDS)
    want = _read_layers(os.path.join(workdir, 'output_c'))
    moved = {k: int(np.sum(got[k] != want[k])) for k in ('DIAG', 'WTR')}
    say(f'run p: WTR, BWTR, CONF, DIAG, WTR-1, WTR-2, CLOUD == oracle with '
        f'the inexact thresholds (bit for bit), launches {launches}; against '
        f'the default thresholds {moved} px differ')
    return launches


def phase_hosts(torch, workdir, tile, ctx):
    """``dswx_campaign --hosts 2`` on card 0 (two worker processes that
    share the card) against campaign (d), the same three jobs with
    ``--hosts 1``: every product file byte for byte but the processing
    time."""
    from proteus_tpu_torch.cli.dswx_campaign import main as campaign_main

    say('== phase 5d: dswx_campaign --hosts 2 on card 0 against --hosts 1 '
        '(campaign d)')
    dirs = [tile['input_dir'], ctx['tile_b'], ctx['copies']['tile_a2']]
    out = os.path.join(workdir, 'campaign_d')
    want_dir = os.path.join(workdir, 'campaign_d_one_host')
    os.rename(out, want_dir)  # the workers write the same tile names
    stats_path = os.path.join(workdir, 'stats_hosts.json')
    argv = dirs + ['-o', out, '--dem', tile['dem_file'], '-c',
                   tile['lc_file'], '-w', tile['wc_file'], '--browse',
                   '--tiles-per-device', '2', '--product-version', '0.1',
                   '--hosts', '2', '--stats-json', stats_path]
    os.environ['PROTEUS_TPU_TORCH_DEVICE'] = 'cuda:0'
    t0 = time.perf_counter()
    try:
        campaign_main(argv)
    except SystemExit as exc:
        raise AssertionError(f'campaign --hosts 2 exited with {exc.code}')
    finally:
        sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
        os.environ['PROTEUS_TPU_TORCH_DEVICE'] = DEVICE
    wall = time.perf_counter() - t0
    with open(stats_path) as fh:
        stats = json.load(fh)
    if stats != {'tiles_done': 3, 'tiles_failed': 0, 'tiles_total': 3}:
        raise AssertionError(f'campaign --hosts 2: {stats}')
    specs = []
    for k in range(2):
        with open(os.path.join(out, '.dispatch', f'host{k}_r0.json')) as fh:
            spec = json.load(fh)
        specs.append((spec['devices'], len(spec['jobs'])))
    n_files = _same_bytes('--hosts 2', want_dir, out)
    say(f'campaign --hosts 2: {wall:.2f} s wall, workers (devices, jobs) '
        f'{specs}; {n_files} product files == --hosts 1 (campaign d) byte '
        f'for byte (but the processing time)')


def _ingested(tile_dir):
    """A tile's bands clipped at 1, Fmask, invalid mask and geotransform
    through the port's ingest."""
    import numpy as np
    from proteus_tpu_torch.io import hls as hls_io
    from proteus_tpu_torch.tools import datasets
    image = {}
    if not hls_io.load_hls_product_v2(datasets.band_files(tile_dir), image,
                                      {}, {}, {}, False):
        raise AssertionError(f'could not ingest {tile_dir}')
    bands = {k: np.clip(image[k], 1, None)
             for k in ('blue', 'green', 'red', 'nir', 'swir1', 'swir2')}
    return (bands, image['fmask'], image['invalid_ind_array'].astype(bool),
            image['geotransform'])


def _tool_launches(launches, expect, what):
    """Add the launch counts since they were set to 0 to ``launches``,
    check each kernel in ``expect`` launched, and set them to 0 again."""
    counts = _read_counts()
    for name in expect:
        if counts[name] < 1:
            raise AssertionError(f'{what} never launched {name}')
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    _reset_counts()


def phase_tools(torch, workdir, tile):
    """The campaign instruments of ``proteus_tpu_torch/tools`` through their
    ``main`` at full size on card 0: the cold- against warm-grid bench
    (3 + 3 tiles, tile 0 of each run against the oracle), the
    kill-and-resume soaks back to back (int16 then scaled, 6 tiles, the
    kill after 2 done), the host budget (1 pass) and the batch scaling
    (B = 1, 2, 4, int16 and scaled). Each prints its own JSON lines; this
    phase prints one a tool with the card's name and power limit."""
    from proteus_tpu_torch.geo.crs import CRS
    from proteus_tpu_torch.geo.polygon import create_ocean_mask
    from proteus_tpu_torch.testing import synthetic
    from proteus_tpu_torch.tools import (bench_batch, bench_cold_grid,
                                         host_budget, soak_back_to_back)
    oracle = _load_oracle()
    card = nvidia_smi_line()
    device = f'{DEVICE}:0'
    say(f'== phase 9: the campaign instruments at {SIZE}x{SIZE} on '
        f'{device} ({card})')
    launches = {}
    _reset_counts()

    # 9a: 3 tiles on 3 distinct grids against 3 revisits of one grid
    root = os.path.join(workdir, 'tools_cold_grid')
    out = os.path.join(workdir, 'cold_grid.json')
    t0 = time.perf_counter()
    if bench_cold_grid.main(['--tiles', '3', '--size', str(SIZE), '--root',
                             root, '--device', device, '--out',
                             out]) != 0:
        raise AssertionError('bench_cold_grid failed')
    wall = time.perf_counter() - t0
    _tool_launches(launches, ('wtr_k1', 'wtr_k5', 'wtr_k6', 'warp_nearest',
                              'warp_cubic'), 'bench_cold_grid')
    with open(out) as fh:
        report = json.load(fh)
    wkt = CRS.from_epsg(synthetic.EPSG).to_wkt()
    for label, misses in (('cold', 3), ('warm', 1)):
        row = report[label]
        if row['cache_misses'] != dict.fromkeys(
                ('dem_warp', 'landcover', 'ocean', 'shadow'), misses):
            raise AssertionError(f'bench_cold_grid {label}: cache misses '
                                 f'{row["cache_misses"]}')
        tid = f'{label}_00'
        bands, fmask, invalid, gt = _ingested(os.path.join(root, tid))
        if label == 'warm':
            ocean = tile['ocean']  # phase 4's grid and shoreline
        else:
            ocean = create_ocean_mask(
                os.path.join(root, tid, 'anc', 'shoreline.shp'), 1, workdir,
                gt, wkt, SIZE, SIZE)
        _hold_against_oracle(oracle, f'{label} {tid}', _read_layers(
            os.path.join(root, label, tid), tid, browse=False), bands, fmask,
            invalid, 'mask', ocean=ocean)
        say(json.dumps({'tool': 'bench_cold_grid', 'run': label,
                        'card': card, **row}))
        say(f'bench_cold_grid {label}: peak device memory '
            f'{row["peak_device_memory_bytes"] / 2**30:.3f} GiB (with the '
            f'eager warp: {EAGER_WARP_PEAK_GIB[label]} GiB)')
    say(f'bench_cold_grid: {wall:.1f} s with the inputs; cold '
        f'{report["cold"]["tiles_per_min"]:.2f} tiles/min, warm '
        f'{report["warm"]["tiles_per_min"]:.2f}, warm/cold '
        f'{report["cold_over_warm_ratio"]:.3f}; tile 0 of each run == '
        f'oracle (WTR, BWTR, CONF, DIAG, WTR-1, WTR-2, CLOUD)')

    # 9b: the kill-and-resume soaks, int16 then scaled
    out = os.path.join(workdir, 'soak_b2b.json')
    t0 = time.perf_counter()
    if soak_back_to_back.main(
            ['--tiles', '6', '--size', str(SIZE), '--kill-after-done', '2',
             '--timeout', '300', '--root', os.path.join(workdir,
                                                        'tools_soak'),
             '--device', device, '--out', out]) != 0:
        raise AssertionError('soak_back_to_back failed')
    wall = time.perf_counter() - t0
    with open(out) as fh:
        summary = json.load(fh)
    for run in summary['runs']:
        if run['status'] != 'pass' or not run['killed_mid_campaign']:
            raise AssertionError(f'soak {run["mode"]}: status '
                                 f'{run["status"]}, killed mid-campaign '
                                 f'{run["killed_mid_campaign"]}')
    say(json.dumps({'tool': 'soak_back_to_back', 'card': card, **summary}))
    say(f'soak_back_to_back: {wall:.1f} s; ' + '; '.join(
        f'{r["mode"]}: phase A {r["phase_a_s"]:.2f} s, B '
        f'{r["phase_b_s"]:.2f} s, fault {r["fault"]}'
        for r in summary['runs'])
        + f'; phase B scaled/int {summary["phase_b_scaled_over_int"]:.3f}')

    # 9c: the host budget, one pass
    out = os.path.join(workdir, 'host_budget.json')
    if host_budget.main(['--size', str(SIZE), '--passes', '1', '--root',
                         workdir, '--device', device, '--out',
                         out]) != 0:
        raise AssertionError('host_budget failed')
    _tool_launches(launches, ('wtr_k1',), 'host_budget')
    with open(out) as fh:
        budget = json.load(fh)
    say(json.dumps({'tool': 'host_budget', 'card': card,
                    'codec': budget['codec'],
                    'cpu_count': budget['cpu_count'],
                    'total_core_s_per_tile': budget['total_core_s_per_tile'],
                    'total_core_s_per_tile_realistic':
                        budget['total_core_s_per_tile_realistic'],
                    **{f'{k} s': v['seconds']
                       for k, v in budget['stages'].items()},
                    **{f'{k} s (realistic)': v['seconds']
                       for k, v in budget['stages_realistic'].items()}}))

    # 9d: the batch scaling, int16 and scaled bands
    for scaled, expect in ((False, ('wtr_k1', 'wtr_k5', 'wtr_k6')),
                           (True, ('wtr_k4', 'wtr_k5', 'wtr_k6'))):
        out = os.path.join(workdir, f'bench_batch_{int(scaled)}.json')
        if bench_batch.main(['--size', str(SIZE), '--device', device,
                             '--out', out]
                            + (['--scaled'] if scaled else [])) != 0:
            raise AssertionError('bench_batch failed')
        _tool_launches(launches, expect, 'bench_batch')
        with open(out) as fh:
            points = json.load(fh)['points']
        say(json.dumps({'tool': 'bench_batch', 'scaled': scaled,
                        'card': card, 'ms_per_tile': {
                            p['tiles_per_dispatch']: p['s_per_tile'] * 1e3
                            for p in points}}))
    return launches


def _check_no_jax():
    loaded = sorted(m for m in sys.modules
                    if m == 'jax' or m.split('.')[0] == 'proteus_tpu')
    if loaded:
        raise AssertionError(f'modules of jax or proteus_tpu were imported: '
                             f'{loaded}')


def _last_lines(torch, *lines):
    """The end of a run: no module of jax or proteus_tpu loaded, then the
    card's name and power limit, ``lines``, and the result line."""
    _check_no_jax()
    say(nvidia_smi_line())
    for line in lines:
        say(line)
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def main(argv=None):
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'needs a CUDA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if not os.path.isdir(os.path.join(REPO, 'proteus_tpu_torch')):
        print('chip_smoke: run it from a checkout of the repository',
              file=sys.stderr)
        return 2

    os.environ['PROTEUS_TPU_STAGE_TIMES'] = '1'
    argv = sys.argv[1:] if argv is None else argv
    multi_only = '--multi-gpu' in argv
    phase_device(torch)
    phase_build()
    if multi_only:
        if torch.cuda.device_count() < 2:
            raise AssertionError('--multi-gpu needs two or more cards')
        with tempfile.TemporaryDirectory(prefix='chip_smoke_') as workdir:
            phase_multi_gpu(torch, workdir)
        return _last_lines(torch)
    stats, inputs, planes, fmasks, copy_bw = phase_kernel_vs_plain(torch)
    batched, scaled = phase_batched_vs_plain(torch, inputs, planes, fmasks,
                                             copy_bw)
    stats.update(batched)
    stats.update(phase_spatial_vs_plain(torch, inputs, planes, fmasks,
                                        scaled, copy_bw))
    stats.update(phase_null_vs_plain(torch, inputs, copy_bw))
    del inputs, planes, fmasks, scaled
    torch.cuda.empty_cache()
    os.environ['PROTEUS_TPU_TORCH_DEVICE'] = DEVICE
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as workdir:
        stats.update(phase_warp_vs_plain(torch, workdir))
        torch.cuda.empty_cache()
        launches, tile = phase_main_path(torch, workdir)
        for name, n in phase_inexact_run(torch, workdir, tile).items():
            launches[name] = launches.get(name, 0) + n
        campaigns, ctx = phase_campaign(torch, workdir, tile)
        campaigns.update({k: campaigns.get(k, 0) + n for k, n in
                          phase_spatial_campaign(torch, workdir, tile,
                                                 ctx).items()})
        for name, n in campaigns.items():
            launches[name] = launches.get(name, 0) + n
        phase_hosts(torch, workdir, tile, ctx)
        phase_step_sweep(torch, tile, workdir)
        for phase in (phase_profile, phase_otsu_and_s2, phase_tools):
            for name, n in phase(torch, workdir, tile).items():
                launches[name] = launches.get(name, 0) + n
        if torch.cuda.device_count() > 1:
            phase_multi_gpu(torch, workdir)
        else:
            say('== phase 6: skipped, one card visible')

    replaces = {'wtr_k1': 'ops/pallas/wtr_kernel.py:351',
                'wtr_k2': 'ops/pallas/wtr_kernel.py:465',
                'wtr_k3': 'ops/pallas/wtr_kernel.py:291',
                'wtr_k4': 'ops/pallas/wtr_kernel.py:302',
                'wtr_k5': 'ops/pallas/wtr_kernel.py:483',
                'wtr_k6': 'parallel/campaign.py:251',
                'wtr_k6_spatial': 'parallel/campaign.py:394'}
    kernels = [{'name': name, 'route': 'cuda',
                'source': 'proteus_tpu_torch/ops/csrc/wtr_kernel.cu',
                'replaces': f'proteus_tpu/{where}',
                'launches': launches.get(name, 0), **stats[name]}
               for name, where in replaces.items()]
    kernels.append({'name': 'null', 'route': 'cuda',
                    'source': 'proteus_tpu_torch/ops/csrc/null_kernel.cu',
                    'replaces': 'tools/kernel_profile.py:72',
                    'launches': launches.get('null', 0), **stats['null']})
    # the warp replaces a jnp function run as one jit program, not a
    # Pallas kernel; the main paths run nearest and cubic (bilinear only
    # in phase 3e)
    for name in ('warp_nearest', 'warp_cubic'):
        row = {k: v for k, v in stats[name].items()
               if k in ('max_abs_err', 'ms', 'plain_ms', 'bound_ms',
                        'bound_by', 'library_ms')}
        kernels.append({'name': name, 'route': 'cuda',
                        'source': 'proteus_tpu_torch/ops/csrc/warp_kernel.cu',
                        'replaces': 'proteus_tpu/geo/warp.py:521',
                        'launches': launches.get(name, 0), **row})
    for kernel in kernels:
        if kernel['launches'] < 1:
            raise AssertionError(f'{kernel["name"]} was launched no time on '
                                 f'the main paths')
    return _last_lines(torch, json.dumps({'kernels': kernels}))


if __name__ == '__main__':
    sys.exit(main())
