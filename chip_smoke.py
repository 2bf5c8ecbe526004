#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits nonzero:

1. device: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: the CUDA kernels, from the sources in the checkout;
3. kernels vs plain: the CUDA kernels K1, K2 and K3 against the plain
   PyTorch chain on the same 3660 x 3660 tensors on the card, bit for bit,
   in every combination of int16 / float32 bands (float32 operands pushed
   onto the ratio tests' rounding boundaries), 'mask' / 'ignore' / 'cover'
   mode (a random and a structured fmask), ancillary planes and browse;
   then each kernel and its plain version timed with CUDA events;
4. main path: a full-size synthetic HLS tile (3660^2 bands, DEM with its
   50 px margin, 3x WorldCover grid) through
   ``python -m proteus_tpu_torch.cli.dswx_hls``'s ``main`` on ``cuda``
   three times: (c) the default run; (a) 'cover' mode on an Fmask where
   snow meets clear cloud-adjacent pixels, with ocean masking; (b)
   ``--offset-and-scale-inputs``. Each run's launch counts start at 0 and
   must show its kernels; its layers are held against the numpy oracle,
   (a)'s ocean against the host's distance-transform ocean mask, and (c)'s
   DEM and SHAD against the host float64 warp and shadow.

The last lines are the card's name and power limit, a JSON line with each
kernel's launches, error and times, and
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
REPO = os.path.dirname(os.path.abspath(__file__))


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
    from proteus_tpu_torch.ops.build import build
    t0 = time.perf_counter()
    built = build('wtr_kernel')
    say(f'wtr_kernel: {built.path}; nvcc {built.seconds:.2f} s, '
        f'build+load {time.perf_counter() - t0:.2f} s')
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
    (each larger than the 50 MB L2), divided by the batch size."""
    fn(*inputs[0])  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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
    src = torch.empty(nbytes, dtype=torch.uint8, device='cuda')
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
    device = torch.device('cuda')
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
    say(f'kernels == plain chain, bit for bit, in {n_cases} combinations '
        f'(int16/float32 bands x mask/ignore/cover x ancillaries x browse;'
        f' {n_runs} runs, the cover ones on a random and a structured '
        f'fmask; boundary-pushed float32 bands); max |err| {errors}')

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
    # slice: (bands, mode, bytes a pixel moves), as in csrc/wtr_kernel.cu
    cells = {'wtr_k1': ('int16', 'mask', 25),
             'wtr_k3': ('float32', 'mask', 37),
             'wtr_k2': ('int16', 'cover', 28)}
    copy_bw = _copy_bandwidth(torch)
    stats = {}
    for name, (dtype, mode, bytes_px) in cells.items():
        cfg = configs[mode]

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
                       'plain_ms': pms}

    # K2's second pass alone, on the state bytes of its first
    out, state, flags = wtr_kernel.pixel_pass(*inputs['int16'][0],
                                              configs['cover'], **main_kw)
    pass_b = [_time_ms(torch, lambda: wtr_kernel.launch_k2(state, out, flags),
                       [()], 10, cycles=16) for _ in range(2)]
    say(f'wtr_k2 pass B alone (state + WTR-2 in, 5 layers out): '
        f'{statistics.median(pass_b):.4f} ms/tile (runs {pass_b}); '
        f'device copy {copy_bw / 1e9:.1f} GB/s')
    return stats


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_cli(torch, label, argv, expect):
    """One product run through the CLI's ``main`` with the launch counts
    set to 0 just before it; checks that each slice in ``expect`` launched
    and returns the counts."""
    from proteus_tpu_torch.cli.dswx_hls import main as dswx_hls_main
    from proteus_tpu_torch.ops import wtr_kernel

    log = logging.getLogger('dswx_hls')
    collect = _Collect()
    log.addHandler(collect)
    torch.cuda.reset_peak_memory_stats()
    for name in wtr_kernel.LAUNCHES:
        wtr_kernel.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    try:
        ok = dswx_hls_main(argv)
    finally:
        # the CLI routes stdout/stderr into its logger
        sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
        log.removeHandler(collect)
    wall = time.perf_counter() - t0
    launches = dict(wtr_kernel.LAUNCHES)
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


def _read_layers(output_dir):
    from proteus_tpu_torch.host import TiffReader
    prefix = os.path.join(output_dir, 'dswx_hls_test_v0.1_')
    layers = ['WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'LAND',
              'SHAD', 'CLOUD', 'DEM']
    got = {}
    for nn, layer in enumerate(layers, start=1):
        with TiffReader(f'{prefix}B{nn:02}_{layer}.tif') as r:
            got[layer] = r.read()
    for suffix in ('BROWSE.png', 'BROWSE.tif'):
        if not os.path.isfile(prefix + suffix):
            raise AssertionError(f'missing {prefix + suffix}')
    return got


def _hold_against_oracle(oracle, label, got, bands, fmask, invalid, mode,
                         ocean=None):
    """The per-pixel layers vs the numpy oracle, fed the run's own SHAD and
    LAND (as tests/test_workflow.py does)."""
    import numpy as np
    from proteus_tpu_torch.host import HlsThresholds
    t = HlsThresholds()
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


def phase_main_path(torch, workdir):
    import shutil
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    import oracle
    import synthetic
    from proteus_tpu_torch.host import (CRS, TiffReader, create_ocean_mask,
                                        warp_to_grid, write_cog)
    from proteus_tpu_torch.models.dswx.shadow import _host_shadow_exact

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
            launches[name] += n

    # (c) the default run: int16, 'mask' (K1); DEM and SHAD vs the host
    count(_run_cli(torch, 'c (default: int16, mask)', [rc['c']],
                   ('wtr_k1',)))
    got = _read_layers(os.path.join(workdir, 'output_c'))
    _hold_against_oracle(oracle, 'c', got, ints, raw['Fmask'], invalid,
                         'mask')
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
        raise AssertionError('SHAD differs from the host shadow')
    for layer in ('LAND', 'SHAD'):
        vals, counts = np.unique(got[layer], return_counts=True)
        say(f'  {layer} classes: {dict(zip(vals.tolist(), counts.tolist()))}')
    say('run c: WTR, BWTR, CONF, DIAG, WTR-1, WTR-2, CLOUD == oracle; DEM '
        '== host warp; SHAD == host shadow (bit for bit)')

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
    cloud = got['CLOUD']
    ignore = np.where(cloud == 255, 255,
                      (cloud & 0xFD) | 2 * ((fmask_a & 16) != 0))
    changed = int((cloud != ignore).sum())
    if changed == 0:
        raise AssertionError("run a: 'cover' changed no CLOUD pixel")
    say(f"run a: all layers == oracle (scipy dilations); ocean == host "
        f"ocean mask, {share:.2%} of the tile; 'cover' changed {changed} "
        f"CLOUD px against 'ignore'")

    # (b) --offset-and-scale-inputs (K3), the cast of io/hls.py:185
    count(_run_cli(torch, 'b (float32 scaled, mask)',
                   [rc['b'], '--offset-and-scale-inputs'], ('wtr_k3',)))
    got = _read_layers(os.path.join(workdir, 'output_b'))
    scale, offset = float(md['scale_factor']), float(md['add_offset'])
    scaled = {k: scale * (np.asarray(v, dtype=np.float32) - offset)
              for k, v in ints.items()}
    _hold_against_oracle(oracle, 'b', got, scaled, raw['Fmask'], invalid,
                         'mask')
    say('run b: all layers == oracle on the float32 bands (bit for bit)')
    return launches


def main():
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

    phase_device(torch)
    phase_build()
    stats = phase_kernel_vs_plain(torch)
    torch.cuda.empty_cache()
    os.environ['PROTEUS_TPU_TORCH_DEVICE'] = 'cuda'
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as workdir:
        launches = phase_main_path(torch, workdir)
    if 'jax' in sys.modules:
        raise AssertionError('jax was imported')

    replaces = {'wtr_k1': 351, 'wtr_k2': 465, 'wtr_k3': 291}
    say(nvidia_smi_line())
    say(json.dumps({'kernels': [{
        'name': name, 'route': 'cuda',
        'source': 'proteus_tpu_torch/ops/csrc/wtr_kernel.cu',
        'replaces': f'proteus_tpu/ops/pallas/wtr_kernel.py:{line}',
        'launches': launches[name], **stats[name]}
        for name, line in replaces.items()]}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
