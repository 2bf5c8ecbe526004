#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Usage (from the root of a checkout, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits nonzero:

1. device: the card's name and power limit, torch/CUDA/nvcc versions;
2. build: the CUDA kernels, from the sources in the checkout;
3. kernel vs plain: the fused per-pixel kernel against the plain PyTorch
   chain on the same 3660 x 3660 tensors on the card, in every flag
   combination, bit for bit; then both timed with CUDA events;
4. main path: a full-size synthetic HLS tile (3660^2 bands, DEM with its
   50 px margin, 3x WorldCover grid) through
   ``python -m proteus_tpu_torch.cli.dswx_hls``'s ``main`` on ``cuda``;
   the layers are held against the numpy oracle, the host float64 warp
   and the host float64 shadow.

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


def phase_kernel_vs_plain(torch):
    import itertools
    import numpy as np
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.ops import wtr_kernel

    say('== phase 3: kernel vs plain chain on the card, '
        f'{SIZE}x{SIZE}')
    device = torch.device('cuda')
    rng = np.random.default_rng(20261016)
    bands, planes = _random_inputs(torch, rng, device)
    max_err = 0
    n_cases = 0
    for (with_ocean, with_shadow, with_lc), mode, browse in \
            itertools.product(itertools.product((False, True), repeat=3),
                              ('mask', 'ignore'), (False, True)):
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
        args = (*bands, planes['fmask'], planes['invalid'], cfg)
        got = wtr_kernel.wtr_layers(*args, **kw)
        want = wtr_kernel.wtr_layers_plain(*args, **kw)
        torch.cuda.synchronize()
        if sorted(got) != sorted(want):
            raise AssertionError(f'layer sets differ: {sorted(got)} '
                                 f'vs {sorted(want)}')
        for name in want:
            a = got[name].to(torch.int32)
            b = want[name].to(torch.int32)
            err = int((a - b).abs().max())
            max_err = max(max_err, err)
            if not torch.equal(a, b):
                raise AssertionError(
                    f'{name} differs (max |err| {err}) with ocean='
                    f'{with_ocean} shadow={with_shadow} landcover={with_lc}'
                    f' mode={mode} browse={browse}')
        n_cases += 1
    say(f'kernel == plain chain, bit for bit, in {n_cases} flag '
        f'combinations (max |err| {max_err})')

    # timing at the main path's flags, over varied inputs
    cfg = DswxChainConfig()
    inputs = [(*bands, planes['fmask'], planes['invalid'])]
    for _ in range(3):
        b2, p2 = _random_inputs(torch, rng, device)
        inputs.append((*b2, p2['fmask'], p2['invalid']))

    def kernel(*a):
        return wtr_kernel.wtr_layers(*a, cfg, shadow=planes['shadow'],
                                     landcover=planes['landcover'])

    def plain(*a):
        return wtr_kernel.wtr_layers_plain(*a, cfg, shadow=planes['shadow'],
                                           landcover=planes['landcover'])
    plain_ms = [_time_ms(torch, plain, inputs, 3)]
    kernel_ms = [_time_ms(torch, kernel, inputs, 10)]
    kernel_ms.append(_time_ms(torch, kernel, inputs, 10))
    plain_ms.append(_time_ms(torch, plain, inputs, 3))
    ms, pms = statistics.median(kernel_ms), statistics.median(plain_ms)
    bytes_per_tile = 25 * SIZE * SIZE  # 16 B in + 9 B out per pixel
    copy_bw = _copy_bandwidth(torch)
    say(f'kernel {ms:.4f} ms/tile (runs {kernel_ms}), plain chain '
        f'{pms:.4f} ms/tile (runs {plain_ms}); kernel moves '
        f'{bytes_per_tile / 1e6:.1f} MB/tile = '
        f'{bytes_per_tile / (ms * 1e-3) / 1e9:.1f} GB/s; device copy '
        f'{copy_bw / 1e9:.1f} GB/s')
    return {'max_abs_err': max_err, 'ms': ms, 'plain_ms': pms}


class _Collect(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase_main_path(torch, workdir):
    import numpy as np
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    import oracle
    import synthetic
    from proteus_tpu_torch.cli.dswx_hls import main as dswx_hls_main
    from proteus_tpu_torch.host import (CRS, HlsThresholds, TiffReader,
                                        warp_to_grid)
    from proteus_tpu_torch.models.dswx.shadow import _host_shadow_exact
    from proteus_tpu_torch.ops import wtr_kernel

    say('== phase 4: main path through the CLI, full-size synthetic tile')
    t0 = time.perf_counter()
    input_dir = os.path.join(workdir, 'input')
    output_dir = os.path.join(workdir, 'output')
    _, bands = synthetic.make_hls_v2_dataset(input_dir, size=SIZE)
    dem_file = synthetic.make_dem(workdir, size=SIZE)
    lc_file = synthetic.make_landcover(workdir, size=SIZE)
    wc_file = synthetic.make_worldcover(workdir, size=SIZE)
    rc = synthetic.write_runconfig(
        os.path.join(workdir, 'rc.yaml'), input_dir, output_dir,
        os.path.join(workdir, 'scratch'), dem_file=dem_file,
        landcover_file=lc_file, worldcover_file=wc_file,
        check_coverage=True)
    say(f'synthetic tile written in {time.perf_counter() - t0:.1f} s')

    log = logging.getLogger('dswx_hls')
    collect = _Collect()
    log.addHandler(collect)
    torch.cuda.reset_peak_memory_stats()
    wtr_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        ok = dswx_hls_main([rc])
    finally:
        # the CLI routes stdout/stderr into its logger
        sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
        log.removeHandler(collect)
    wall = time.perf_counter() - t0
    launches = wtr_kernel.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if ok is not True:
        raise AssertionError(f'generate_dswx_layers returned {ok!r}')
    if launches < 1:
        raise AssertionError('the main path never launched the kernel')
    say(f'main path: {wall:.2f} s wall, {launches} kernel launch(es), '
        f'peak device memory {peak / 2**30:.3f} GiB')
    start = collect.lines.index('stage timing breakdown:')
    for line in collect.lines[start:]:
        if line.startswith('    ') or line.endswith(':'):
            say(f'  {line}')

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

    # per-pixel layers vs the float64 numpy oracle, fed the port's own
    # SHAD and LAND (as tests/test_workflow.py does)
    t = HlsThresholds()
    invalid = np.zeros((SIZE, SIZE), bool)
    arrs = {}
    for key, name in [('blue', 'B02'), ('green', 'B03'), ('red', 'B04'),
                      ('nir', 'B8A'), ('swir1', 'B11'), ('swir2', 'B12')]:
        invalid |= bands[name] == -9999
        arrs[key] = np.clip(bands[name], 1, None)
    want = oracle.full_chain(
        arrs['blue'], arrs['green'], arrs['red'], arrs['nir'],
        arrs['swir1'], arrs['swir2'], bands['Fmask'], invalid,
        {k: getattr(t, k) for k in t.__dataclass_fields__}, mode='mask',
        aerosol_lists={0: [224, 160, 96], 2: [224, 160, 96],
                       3: [224, 192, 160, 128, 96],
                       4: [224, 192, 160, 128, 96]},
        shadow=got['SHAD'], landcover=got['LAND'])
    for layer in ('WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'CLOUD'):
        expected = want[layer]
        if layer in ('WTR', 'WTR-1', 'WTR-2'):
            expected = oracle.collapse(expected)
        if not np.array_equal(got[layer], expected):
            raise AssertionError(f'{layer} differs from the oracle in '
                                 f'{int((got[layer] != expected).sum())} px')

    # DEM vs the host float64 warp; SHAD vs the host float64 shadow
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
    for layer in ('LAND', 'SHAD', 'WTR'):
        vals, counts = np.unique(got[layer], return_counts=True)
        say(f'  {layer} classes: {dict(zip(vals.tolist(), counts.tolist()))}')
    say('WTR, BWTR, CONF, DIAG, WTR-1, WTR-2, CLOUD == oracle; DEM == host '
        'warp; SHAD == host shadow (bit for bit)')
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

    say(nvidia_smi_line())
    say(json.dumps({'kernels': [{
        'name': 'wtr_k1', 'route': 'cuda',
        'source': 'proteus_tpu_torch/ops/csrc/wtr_kernel.cu',
        'replaces': 'proteus_tpu/ops/pallas/wtr_kernel.py:150',
        'launches': launches, 'max_abs_err': stats['max_abs_err'],
        'ms': stats['ms'], 'plain_ms': stats['plain_ms']}]}))
    say(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
