"""dswx_campaign command-line entry point of the PyTorch port: batched
multi-tile production over the local GPUs.

Usage: python -m proteus_tpu_torch.cli.dswx_campaign <tile dirs> -o <out>

The same arguments as ``proteus_tpu/cli/dswx_campaign.py``: give it many
HLS tile directories and it splits tile batches over the devices with
prefetched host I/O, a resume manifest, and per-tile retry. The devices
come from ``PROTEUS_TPU_TORCH_DEVICE`` (default ``cuda``: every visible
GPU; ``cuda:N`` one of them; ``cpu`` the CPU); asking for CUDA on a
machine without it is an error. ``--spatial-shards N`` cuts each tile's
rows over N of them (their number must divide by N). ``--hosts N``
dispatches the tiles over N worker processes
(``parallel/dispatch.py``), which share the machine's cards: each takes its
own subset of them, or with fewer cards than workers they share one.

Examples:
    python -m proteus_tpu_torch.cli.dswx_campaign tiles/T15RYP tiles/T15RYN -o out/
    python -m proteus_tpu_torch.cli.dswx_campaign --tiles-list tiles.txt -o out/
"""

import argparse
import glob
import json
import logging
import os
import sys

from proteus_tpu_torch.core.thresholds import HlsThresholds
from proteus_tpu_torch.device import resolve_device
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.runtime.logging_util import create_logger

logger = logging.getLogger('dswx_hls')


def get_parser():
    parser = argparse.ArgumentParser(
        description='Batched DSWx-HLS campaign across the local GPUs',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('input_dirs', nargs='*',
                        help='HLS tile directories (one product each)')
    parser.add_argument('--tiles-list', type=str,
                        help='File listing one HLS tile directory per '
                             'line')
    parser.add_argument('-o', '--output-dir', required=True,
                        help='Campaign output directory (one '
                             'subdirectory per tile)')
    parser.add_argument('--manifest', type=str, default=None,
                        help='Campaign manifest JSON (enables '
                             'resume/retry bookkeeping); defaults to '
                             '<output-dir>/campaign_manifest.json')
    parser.add_argument('--product-version', type=str, default='1.0')
    parser.add_argument('--max-retries', type=int, default=2)
    parser.add_argument('--reader-threads', type=int, default=None,
                        help='default: scaled to the host core count')
    parser.add_argument('--writer-threads', type=int, default=None,
                        help='default: scaled to the host core count')
    parser.add_argument('--mask-adjacent-to-cloud-mode', type=str,
                        choices=['mask', 'ignore', 'cover'],
                        default='mask')
    parser.add_argument('--shadow-masking-algorithm', type=str,
                        choices=['sun_local_inc_angle', 'otsu'],
                        default='sun_local_inc_angle',
                        help='Terrain shadow algorithm for the SHAD '
                             'layer (reference shadow_masking_'
                             'algorithm runconfig key)')
    parser.add_argument('--dem', dest='dem_file', type=str,
                        help='Shared DEM covering all tiles (enables the '
                             'SHAD + DEM layers)')
    parser.add_argument('-c', '--landcover', dest='landcover_file',
                        type=str, help='Shared CGLS landcover file')
    parser.add_argument('-w', '--worldcover', dest='worldcover_file',
                        type=str, help='Shared ESA WorldCover file')
    parser.add_argument('-s', '--shoreline',
                        dest='shoreline_shapefile', type=str,
                        help='GSHHS shoreline shapefile (enables ocean '
                             'masking)')
    parser.add_argument('--ocean-masking-distance-km', type=float,
                        default=1.0)
    parser.add_argument('--browse', dest='save_browse',
                        action='store_true', default=False,
                        help='Also produce browse GeoTIFF + PNG per tile')
    parser.add_argument('--scaled', dest='scaled_inputs',
                        action='store_true', default=False,
                        help='Apply per-band scale/offset at ingest and '
                             'run the float32 science chain (reference '
                             'flag_offset_and_scale_inputs)')
    parser.add_argument("--tiles-per-device", type=int, default=None,
                        help="Tiles per device per batch (one kernel "
                             "launch each). Default: CUDA_DEFAULT_TILES_"
                             "PER_DEVICE of parallel/campaign.py on "
                             "CUDA, 1 on the CPU")
    parser.add_argument("--spatial-shards", type=int, default=1,
                        help='Shard each tile spatially over this many '
                             'devices (the device count must divide by '
                             'it)')
    parser.add_argument('--hosts', type=int, default=1,
                        help='Dispatch the campaign across this many '
                             'host worker processes, which share the '
                             'visible GPUs')
    parser.add_argument('--debug', dest='flag_debug',
                        action='store_true', default=False,
                        help='Read only 1000x1000 windows')
    parser.add_argument('--stats-json', type=str, default=None,
                        help='Write the final campaign statistics '
                             '(incl. the per-stage core-seconds table '
                             'when PROTEUS_TPU_STAGE_TIMES=1) to this '
                             'JSON file')
    parser.add_argument('--log', '--log-file', dest='log_file', type=str)
    return parser


def _devices():
    """The campaign's devices from PROTEUS_TPU_TORCH_DEVICE: 'cuda' is
    every visible GPU, 'cuda:N' one, 'cpu' the CPU."""
    from proteus_tpu_torch.parallel.mesh import make_tile_mesh
    device = resolve_device(os.environ.get('PROTEUS_TPU_TORCH_DEVICE',
                                           'cuda'))
    if device.type == 'cuda' and device.index is None:
        return make_tile_mesh()
    return make_tile_mesh([device])


def main(argv=None):
    args = get_parser().parse_args(argv)
    device_spec = os.environ.get('PROTEUS_TPU_TORCH_DEVICE', 'cuda')
    if args.hosts > 1:
        resolve_device(device_spec)  # the workers pick their own devices
    else:
        devices = _devices()
    create_logger(args.log_file)

    tile_dirs = list(args.input_dirs)
    if args.tiles_list:
        with open(args.tiles_list) as fh:
            tile_dirs += [ln.strip() for ln in fh
                          if ln.strip() and not ln.startswith('#')]
    if not tile_dirs:
        logger.error('ERROR no input tiles given')
        sys.exit(2)

    from proteus_tpu_torch.parallel.campaign import CampaignRunner, TileJob

    jobs = []
    for d in tile_dirs:
        files = sorted(glob.glob(os.path.join(d, '*.tif')))
        if not files:
            logger.warning(f'WARNING no .tif files in {d}; skipping')
            continue
        tile_id = os.path.basename(os.path.normpath(d))
        jobs.append(TileJob(
            tile_id, files, os.path.join(args.output_dir, tile_id),
            product_id=tile_id, product_version=args.product_version,
            dem_file=args.dem_file, landcover_file=args.landcover_file,
            worldcover_file=args.worldcover_file,
            shoreline_shapefile=args.shoreline_shapefile,
            ocean_masking_shoreline_distance_km=
            args.ocean_masking_distance_km))

    manifest = args.manifest or os.path.join(args.output_dir,
                                             'campaign_manifest.json')
    os.makedirs(args.output_dir, exist_ok=True)

    def finish(stats):
        logger.info(f'campaign complete: {stats}')
        if args.stats_json:
            with open(args.stats_json, 'w') as fh:
                json.dump(stats, fh, indent=1)
        if stats['tiles_failed']:
            sys.exit(1)

    if args.hosts > 1:
        from proteus_tpu_torch.parallel.dispatch import dispatch_campaign
        _, stats = dispatch_campaign(
            jobs, n_hosts=args.hosts, manifest_path=manifest,
            scratch_dir=os.path.join(args.output_dir, '.dispatch'),
            config_kwargs=dict(
                mask_adjacent_to_cloud_mode=
                args.mask_adjacent_to_cloud_mode,
                shadow_masking_algorithm=
                args.shadow_masking_algorithm),
            save_browse=args.save_browse, device=device_spec,
            runner_kwargs=dict(
                max_retries=args.max_retries,
                reader_threads=args.reader_threads,
                writer_threads=args.writer_threads,
                flag_debug=args.flag_debug,
                spatial_shards=args.spatial_shards,
                tiles_per_device=args.tiles_per_device,
                scaled_inputs=args.scaled_inputs))
        return finish(stats)

    config = DswxChainConfig(
        thresholds=HlsThresholds(),
        mask_adjacent_to_cloud_mode=args.mask_adjacent_to_cloud_mode,
        shadow_masking_algorithm=args.shadow_masking_algorithm)
    runner = CampaignRunner(config=config, mesh=devices,
                            manifest_path=manifest,
                            max_retries=args.max_retries,
                            reader_threads=args.reader_threads,
                            writer_threads=args.writer_threads,
                            flag_debug=args.flag_debug,
                            save_browse=args.save_browse,
                            spatial_shards=args.spatial_shards,
                            tiles_per_device=args.tiles_per_device,
                            scaled_inputs=args.scaled_inputs)
    finish(runner.run(jobs))


if __name__ == '__main__':
    main()
