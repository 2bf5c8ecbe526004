"""Cold- against warm-ancillary-grid campaign benchmark.

The twin of ``tools/bench_cold_grid.py`` for the PyTorch port. A campaign
whose tiles share one product grid pays the grid's ancillary bill (DEM
warp, terrain shadow, landcover warps and LAND, ocean mask) once and then
reads it from ``ANCILLARY_CACHE``; a campaign over many grids pays it on
every tile. The tool records both, through the port's ``CampaignRunner``
in-process on one device (per-tile ancillary files need ``TileJob``'s
per-job fields, which the CLI's shared ``--dem`` does not expose):

  cold   N tiles on N distinct product grids (the synthetic origin shifted
         1.25 tile widths apart, all in UTM zone 15N), each with its own
         DEM, CGLS, WorldCover and shoreline: every cache key misses;
  warm   N revisits of one grid sharing one ancillary set: the first
         tile misses, the others hit.

Both runs start from a cleared cache and stage table, with the same runner
settings. The report names the COG codec in use (``native.codec()``: the
host stages are mostly its encodes). One JSON line a run: tiles/min and
tiles/hour, the per-stage core-seconds, the ancillary cache's misses by
kind (cold N each, warm 1) and the device's peak memory
(``torch.cuda.max_memory_allocated()``; a cold run computes up to
``PROTEUS_TPU_PREP_THREADS`` grids' warps at once, and only the cache's
capacity in keys bounds what stays resident). Then a
line with ``cold_over_warm_ratio``, the warm run's tiles/min over the
cold's. The inputs are written before each run's clock starts.

Usage:
    python -m proteus_tpu_torch.tools.bench_cold_grid [--tiles 16]
        [--size 3660] [--skip-warm] [--root DIR] [--out PATH]
        [--device cuda]

``--root`` holds the inputs and products (default: a temporary directory,
removed at the end; a named root is kept, and its inputs are reused).
``--out`` writes the report there; without it no file is written.
``--device cpu --size 64`` checks the tool on the host (no measurement).
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import torch

from proteus_tpu_torch.device import resolve_device
from proteus_tpu_torch.tools import datasets


def build_cold(root, n, size):
    """``n`` tiles on ``n`` distinct product grids (a 2 x ceil(n/2) raster
    of origins 1.25 tile widths apart), each with its own ancillaries:
    [(tile directory, ancillary directory)]."""
    from proteus_tpu_torch.testing import synthetic
    x0, y0 = synthetic.X0, synthetic.Y0
    pitch = 1.25 * size * abs(synthetic.DX)
    tiles = []
    try:
        for t in range(n):
            gx, gy = t % 2, t // 2
            synthetic.X0 = x0 + (gx - 0.5) * pitch
            synthetic.Y0 = y0 + (gy - (n + 1) // 4) * pitch
            d = os.path.join(root, f'cold_{t:02d}')
            anc = os.path.join(d, 'anc')

            def write(d=d, anc=anc, t=t):
                datasets.write_tile(d, size, seed=7000 + t)
                os.makedirs(anc)
                datasets.write_ancillaries(anc, size,
                                           seeds=(70 + t, 71 + t, 72 + t))
            datasets.write_once(d, '.done', write)
            tiles.append((d, anc))
    finally:
        synthetic.X0, synthetic.Y0 = x0, y0
    return tiles


def build_warm(root, n, size):
    """``n`` tiles on one grid sharing one ancillary set (the revisits of a
    time series): [(tile directory, ancillary directory)]."""
    anc = os.path.join(root, 'anc')
    datasets.write_once(anc, '.done',
                        lambda: datasets.write_ancillaries(anc, size))
    tiles = []
    for t in range(n):
        d = os.path.join(root, f'warm_{t:02d}')
        datasets.write_once(d, '.done', lambda d=d, t=t: datasets.write_tile(
            d, size, seed=7000 + t))
        tiles.append((d, anc))
    return tiles


@contextlib.contextmanager
def counting_misses(cache):
    """Count ``cache``'s misses by the first field of their key (what a
    ``get`` computes) while the block runs; yields the counts."""
    misses = {}
    lock = threading.Lock()
    get = cache.get

    def counting_get(key, compute, *args, **kwargs):
        def counted():
            with lock:
                misses[key[0]] = misses.get(key[0], 0) + 1
            return compute()
        return get(key, counted, *args, **kwargs)

    cache.get = counting_get
    try:
        yield misses
    finally:
        del cache.get


def run_campaign(tiles, out_root, label, device):
    """One campaign over ``tiles`` on ``device`` from a cleared ancillary
    cache and stage table; returns its row."""
    from proteus_tpu_torch.core.thresholds import HlsThresholds
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.parallel import campaign as cmod

    cmod.ANCILLARY_CACHE.clear()
    cmod.STAGE_TIMES.reset()
    # a named root may hold an earlier run's products and manifest, which
    # would mark every tile done
    manifest = os.path.join(out_root, f'manifest_{label}.json')
    shutil.rmtree(os.path.join(out_root, label), ignore_errors=True)
    if os.path.isfile(manifest):
        os.remove(manifest)
    jobs = []
    for d, anc in tiles:
        tid = os.path.basename(d)
        jobs.append(cmod.TileJob(
            tid, datasets.band_files(d), os.path.join(out_root, label, tid),
            product_id=tid, **datasets.ancillary_files(anc)))
    runner = cmod.CampaignRunner(
        config=DswxChainConfig(thresholds=HlsThresholds()), mesh=[device],
        manifest_path=manifest)
    on_cuda = device.type == 'cuda'
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    # the stage table is switched on by PROTEUS_TPU_STAGE_TIMES when the
    # campaign module is imported; a caller may have imported it first
    enabled = cmod.STAGE_TIMES.enabled
    cmod.STAGE_TIMES.enabled = True
    try:
        with counting_misses(cmod.ANCILLARY_CACHE) as misses:
            t0 = time.perf_counter()
            stats = runner.run(jobs)
            dt = time.perf_counter() - t0
    finally:
        cmod.STAGE_TIMES.enabled = enabled
    if stats['tiles_failed']:
        raise RuntimeError(f'{label}: {stats["tiles_failed"]} tiles failed')
    return {'tiles': len(tiles), 'seconds': dt,
            'tiles_per_min': 60.0 * len(tiles) / dt,
            'tiles_per_hour': 3600.0 * len(tiles) / dt,
            'stage_seconds': stats['stage_seconds'],
            'cache_misses': dict(sorted(misses.items())),
            'peak_device_memory_bytes': (
                torch.cuda.max_memory_allocated(device) if on_cuda
                else None)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tiles', type=int, default=16)
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--root', default=None)
    ap.add_argument('--out', default=None)
    ap.add_argument('--skip-warm', action='store_true',
                    help='the cold run only')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    root = args.root or tempfile.mkdtemp(prefix='proteus_cold_grid_')
    name = (torch.cuda.get_device_name(device) if device.type == 'cuda'
            else 'cpu')
    from proteus_tpu_torch import native
    report = {'generated': time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                         time.gmtime()),
              'device': name, 'codec': native.codec(), 'tiles': args.tiles,
              'size': args.size}
    try:
        builds = [('cold', build_cold)]
        if not args.skip_warm:
            builds.append(('warm', build_warm))
        for label, build in builds:
            t0 = time.perf_counter()
            tiles = build(root, args.tiles, args.size)
            print(json.dumps({'built': label,
                              's': time.perf_counter() - t0}), flush=True)
            report[label] = run_campaign(tiles, root, label, device)
            print(json.dumps({'label': label, 'device': name,
                              **report[label]}), flush=True)
        if not args.skip_warm:
            report['cold_over_warm_ratio'] = (
                report['warm']['tiles_per_min']
                / report['cold']['tiles_per_min'])
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({'metric': f'cold_grid_tiles_per_min_{args.size}x'
                                f'{args.size}',
                      'device': name,
                      'cold': report['cold']['tiles_per_min'],
                      'warm': report.get('warm', {}).get('tiles_per_min'),
                      'cold_over_warm_ratio':
                          report.get('cold_over_warm_ratio'),
                      'artifact': args.out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
