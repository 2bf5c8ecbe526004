"""End-to-end campaign benchmark: tiles/min through the full pipeline.

The twin of the repository's root ``bench_e2e.py`` for the PyTorch port.
It measures what ``tools/bench.py``'s science-chain metric does not: ingest
(GeoTIFF decode), per-tile ancillary preparation (ocean mask, DEM warp +
terrain shadow, landcover warps + LAND), the device step and COG encoding
of every product layer, driven by the port's ``CampaignRunner`` with its
reader and writer pools over synthetic tiles
(``proteus_tpu_torch/testing/synthetic.py``).

Protocol: one warm-up tile builds the kernels and fills the caches, then
``--runs`` measured passes over ``--tiles`` tiles each; the MEDIAN pass is
reported. One JSON line, the shape of the root script's, without its
``vs_baseline``: that anchor (1.67 tiles/min) was measured on another
machine and says nothing about this one.

Usage:
    python -m proteus_tpu_torch.tools.bench_e2e [--tiles 8] [--runs 3]
        [--size 3660] [--no-ancillaries] [--root DIR] [--device cuda]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import torch

from proteus_tpu_torch.device import resolve_device


def build_dataset(root, size, ancillaries):
    from proteus_tpu_torch.testing import synthetic
    in_dir = os.path.join(root, 'in')
    stamp = os.path.join(in_dir, f'.stamp_{size}_{int(ancillaries)}')
    if os.path.exists(stamp):
        extra = {}
        if ancillaries:
            extra = dict(
                dem_file=os.path.join(in_dir, 'dem.tif'),
                landcover_file=os.path.join(in_dir, 'landcover.tif'),
                worldcover_file=os.path.join(in_dir, 'worldcover.tif'),
                shoreline_shapefile=os.path.join(in_dir, 'shoreline.shp'))
        files = sorted(
            os.path.join(in_dir, f) for f in os.listdir(in_dir)
            if f.startswith('HLS.') and f.endswith('.tif'))
        return files, extra
    shutil.rmtree(in_dir, ignore_errors=True)
    os.makedirs(in_dir, exist_ok=True)
    files, _ = synthetic.make_hls_v2_dataset(in_dir, size=size)
    extra = {}
    if ancillaries:
        extra = dict(
            dem_file=synthetic.make_dem(in_dir, size=size),
            landcover_file=synthetic.make_landcover(in_dir, size=size),
            worldcover_file=synthetic.make_worldcover(in_dir, size=size),
            shoreline_shapefile=synthetic.make_shoreline(in_dir,
                                                         size=size))
    open(stamp, 'w').close()
    return files, extra


def run_pass(files, extra, out_root, n_tiles, tag, devices):
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.parallel.campaign import (STAGE_TIMES,
                                                     CampaignRunner, TileJob)
    out_dir = os.path.join(out_root, tag)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir, exist_ok=True)
    jobs = [TileJob(f'tile{i:03d}', files,
                    os.path.join(out_dir, f'tile{i:03d}'), **extra)
            for i in range(n_tiles)]
    for j in jobs:
        os.makedirs(j.output_dir, exist_ok=True)
    runner = CampaignRunner(config=DswxChainConfig(), mesh=devices,
                            save_browse=True)
    STAGE_TIMES.reset()  # per-pass stage tables
    t0 = time.time()
    stats = runner.run(jobs)
    dt = time.time() - t0
    if stats['tiles_failed']:
        raise RuntimeError(f'{stats["tiles_failed"]} tiles failed')
    if 'stage_seconds' in stats:
        print(f'# stage core-seconds ({tag}, {n_tiles} tiles):',
              file=sys.stderr)
        for name, rec in stats['stage_seconds'].items():
            print(f'#   {name}: {rec["seconds"]:.1f} s '
                  f'({rec["seconds"] / n_tiles:.2f} s/tile,'
                  f' {rec["calls"]} calls)', file=sys.stderr)
    return dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tiles', type=int, default=8)
    ap.add_argument('--runs', type=int, default=3)
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--no-ancillaries', action='store_true')
    ap.add_argument('--root', default=os.path.join(
        tempfile.gettempdir(), 'proteus_torch_e2e_bench'))
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    devices = [resolve_device(args.device)]
    os.environ.setdefault('PROTEUS_TPU_STAGE_TIMES', '1')

    files, extra = build_dataset(args.root, args.size,
                                 not args.no_ancillaries)
    out_root = os.path.join(args.root, 'out')

    # warm-up: kernel build + caches
    run_pass(files, extra, out_root, 1, 'warm', devices)

    times = []
    for r in range(args.runs):
        dt = run_pass(files, extra, out_root, args.tiles, f'run{r}', devices)
        times.append(dt)
        print(f'# pass {r}: {args.tiles} tiles in {dt:.1f} s '
              f'({args.tiles / dt * 60:.2f} tiles/min)', file=sys.stderr)
    times.sort()
    med = times[len(times) // 2]
    print(json.dumps({
        'metric': f'e2e_campaign_tiles_per_min_{args.size}x{args.size}'
                  + ('' if args.no_ancillaries else '_all_ancillaries'),
        'value': args.tiles / med * 60.0,
        'unit': 'tiles/min',
        'n_passes': args.runs,
        'pass_seconds': times,
        'device': (torch.cuda.get_device_name(devices[0])
                   if devices[0].type == 'cuda' else 'cpu'),
    }), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
