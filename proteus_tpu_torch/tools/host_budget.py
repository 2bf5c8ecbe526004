"""Single-thread host seconds of one tile, stage by stage.

The twin of ``tools/host_budget.py`` for the PyTorch port. A campaign's
stage table sums core-seconds over its pools' threads, which time slicing
inflates; this tool times each host stage alone, the median of
``--passes`` passes in one thread, under the JAX tool's stage names, order
and inputs (``default_rng(3)``, the tile of seed 42):

  ingest_decode     the 6 bands + Fmask of a synthetic HLS v2 tile
                    (``io/hls.load_hls_product_v2``)
  unpack_derive     2-byte/px packed planes -> every layer
                    (``models/dswx/host_derive``)
  cog_uint8_x6      the 6 uint8 science COGs with their overviews
  cog_uint16_diag   the uint16 DIAG COG
  cog_float32_dem   the float32 DEM COG (predictor 3, CUBICSPLINE
                    overviews)
  png_browse        the browse GeoTIFF -> 1024^2 PNG

The rows above encode random class bytes, DEFLATE's worst case, as the
JAX tool does; ``stages_realistic`` encodes the layers the chain makes from
the tile (``ops/wtr_kernel.wtr_layers`` without the aerosol remap: the
plain chain of ``models/dswx/chain.py`` on the CPU, the kernels on a card;
``--device`` decides only where that chain runs). The report names the
native codec (its DEFLATE library) and whether its block decoder and
unpack-derive are in use. One JSON line.

Usage:
    python -m proteus_tpu_torch.tools.host_budget [--size 3660]
        [--passes 3] [--root DIR] [--out PATH] [--device cuda]

``--root`` holds the scratch files (default: a temporary directory,
removed at the end). ``--out`` writes the report there; without it no file
is written.
"""

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from proteus_tpu_torch.device import resolve_device

BANDS = ('blue', 'green', 'red', 'nir', 'swir1', 'swir2')
SCIENCE_LAYERS = ('WTR', 'BWTR', 'CONF', 'WTR-1', 'WTR-2', 'CLOUD')


def median_time(fn, passes):
    times = []
    for _ in range(passes):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def realistic_layers(image, device):
    """The chain's layers of an ingested tile (``load_hls_product_v2``'s
    image dict) on ``device``, as numpy: bands clipped at 1, 'mask' mode,
    no aerosol remap, no ancillaries (the JAX tool's ``oracle.full_chain``
    call)."""
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.ops.wtr_kernel import COUNTS, wtr_layers

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    bands = [dev(np.clip(image[k], 1, None).astype(np.int16)) for k in BANDS]
    out = wtr_layers(*bands, dev(image['fmask']),
                     dev(image['invalid_ind_array'].astype(bool)),
                     DswxChainConfig(apply_aerosol_class_remapping=False),
                     compute_browse=False)
    return {name: t.cpu().numpy() for name, t in out.items()
            if name not in COUNTS}


def budget(size, passes, work, device, say=print):
    """Time every stage in ``work``; returns the report."""
    from proteus_tpu_torch import native
    from proteus_tpu_torch.core import constants as C
    from proteus_tpu_torch.io import hls as hls_io
    from proteus_tpu_torch.io.png import geotiff2png
    from proteus_tpu_torch.models.dswx import host_derive
    from proteus_tpu_torch.runtime import ctables
    from proteus_tpu_torch.runtime import product_writer as pw
    from proteus_tpu_torch.testing import synthetic

    H = W = size
    rng = np.random.default_rng(3)
    results = {'generated': time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                          time.gmtime()),
               'device': (torch.cuda.get_device_name(device)
                          if device.type == 'cuda' else 'cpu'),
               'size': size, 'passes': passes,
               'native_decode_blocks': native.has_decode_blocks(),
               'native_unpack_derive': native.has_unpack_derive(),
               'codec': native.codec(),
               'cpu_count': os.cpu_count(), 'stages': {}}

    def record(table, name, med, times, note=''):
        results[table][name] = {'seconds': med, 'pass_s': times,
                                'note': note}
        say(f'{"[realistic] " if table != "stages" else ""}{name}: '
            f'{med:.3f} s  {note}')

    # --- ingest decode ---------------------------------------------------
    tile_dir = os.path.join(work, 'tile')
    synthetic.make_hls_v2_dataset(tile_dir, size=size, seed=42)
    files = sorted(os.path.join(tile_dir, f)
                   for f in os.listdir(tile_dir) if f.endswith('.tif'))

    def ingest():
        image = {}
        if not hls_io.load_hls_product_v2(files, image, {}, {}, {}, False):
            raise RuntimeError(f'could not read {tile_dir}')
        return image

    record('stages', 'ingest_decode', *median_time(ingest, passes),
           f'{len(files)} band files, {size}^2')

    # --- unpack + derive ---------------------------------------------------
    pa = rng.integers(0, 256, (H, W)).astype(np.uint8)
    # keep diag6 in its domain (0..32) and the packed class indices 0..6
    pa = (pa & 0xC0) | rng.integers(0, 33, (H, W)).astype(np.uint8)
    pb = (rng.integers(0, 4, (H, W))
          | (rng.integers(0, 7, (H, W)) << 2)
          | (rng.integers(0, 7, (H, W)) << 5)).astype(np.uint8)
    opts = dict(flag_collapse_wtr_classes=True,
                exclude_psw_aggressive=False,
                set_not_water_to_nodata=False, set_cloud_to_nodata=True,
                set_snow_to_nodata=False, set_ocean_masked_to_nodata=True)
    layers = {}

    def derive():
        out = {'PACKED_A': pa, 'PACKED_B': pb}
        host_derive.derive_dependent_layers(out, compute_browse=True,
                                            browse_options=opts)
        layers.update(out)

    record('stages', 'unpack_derive', *median_time(derive, passes),
           'native' if native.has_unpack_derive() else 'numpy')

    # --- COG encodes -------------------------------------------------------
    gt = (600000.0, 30.0, 0.0, 4000020.0, 0.0, -30.0)
    proj = 32615
    md = {'PRODUCT_ID': 'host_budget'}
    out8 = os.path.join(work, 'u8.tif')
    out16 = os.path.join(work, 'u16.tif')

    def six_cogs(source, tag):
        def run():
            for i, layer in enumerate(SCIENCE_LAYERS):
                pw.save_dswx_product(source(layer), 'WTR',
                                     out8 + tag + str(i), md, gt, proj)
        return run

    record('stages', 'cog_uint8_x6', *median_time(six_cogs(
        lambda layer: layers.get(layer, layers['WTR']), ''), passes),
        '6 science layers')

    def diag_cog(diag, tag):
        return lambda: pw.save_array(
            diag, out16 + tag, md, gt, proj,
            no_data_value=C.DIAGNOSTIC_LAYER_NO_DATA_BINARY_REPR)

    record('stages', 'cog_uint16_diag',
           *median_time(diag_cog(layers['DIAG'], ''), passes))

    dem = (700.0 + 80.0 * np.sin(np.linspace(0, 40, H))[:, None]
           * np.cos(np.linspace(0, 37, W))[None, :]
           + rng.normal(0, 2.0, (H, W))).astype(np.float32)
    outf = os.path.join(work, 'f32.tif')
    record('stages', 'cog_float32_dem', *median_time(
        lambda: pw.save_array(dem, outf, md, gt, proj,
                              no_data_value=float('nan')), passes),
        'predictor 3 + CUBICSPLINE overviews')

    browse_tif = os.path.join(work, 'browse.tif')
    ct = ctables.get_browse_ctable()
    pw.save_array(layers['BROWSE'], browse_tif, md, gt, proj, ctable=ct,
                  no_data_value=C.UINT8_FILL_VALUE)
    record('stages', 'png_browse', *median_time(
        lambda: geotiff2png(browse_tif, browse_tif.replace('.tif', '.png'),
                            output_height=1024, output_width=1024,
                            rgba_ctable=ct), passes))

    total = sum(v['seconds'] for v in results['stages'].values())
    results['total_core_s_per_tile'] = total

    # --- encodes of the layers the chain makes from the tile ----------------
    real = realistic_layers(ingest(), device)
    results['stages_realistic'] = {}
    record('stages_realistic', 'cog_uint8_x6', *median_time(six_cogs(
        lambda layer: real[layer].astype(np.uint8), 'r'), passes),
        'chain-produced layers')
    record('stages_realistic', 'cog_uint16_diag', *median_time(
        diag_cog(real['DIAG'].astype(np.uint16), 'r'), passes))
    results['total_core_s_per_tile_realistic'] = (
        total - results['stages']['cog_uint8_x6']['seconds']
        - results['stages']['cog_uint16_diag']['seconds']
        + sum(v['seconds'] for v in results['stages_realistic'].values()))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--passes', type=int, default=3)
    ap.add_argument('--root', default=None)
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    work = tempfile.mkdtemp(prefix='host_budget_', dir=args.root)
    try:
        results = budget(args.size, args.passes, work, device,
                         say=lambda msg: print(msg, flush=True))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(results, fh, indent=1)
    print(json.dumps({'metric': f'host_core_s_per_tile_{args.size}x'
                                f'{args.size}', **results,
                      'artifact': args.out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
