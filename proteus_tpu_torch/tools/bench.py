"""Benchmark: full DSWx-HLS science chain throughput on one GPU.

The twin of the repository's root ``bench.py`` for the PyTorch port.
Prints ONE JSON line of the same shape:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Methodology: K dispatches of B distinct tiles each (3660 x 3660 int16
bands -> all product layers with browse), one batched launch of the CUDA
kernel a dispatch (``wtr_layers_batched``, the campaign's execution
pattern), between two CUDA events; dispatch k reads its own first band
(the band plus k, made before the clock starts). The median of
``--passes`` passes is reported. B is ``--tiles-per-dispatch`` (default 2,
the port's CUDA default for ``--tiles-per-device``). ``--float`` benches
the scaled-reflectance mode (float32 bands through K3's body). On
``--device cpu`` the plain PyTorch chain runs on the host clock, a check
of the tool and not a measurement.

The baseline is the reference-equivalent NumPy float64 implementation of
the same chain on this host (``tests/oracle.py::full_chain``, exactly as
the root ``bench.py:52-61`` runs it), so the tool needs a checkout of the
repository around it.

Usage:
    python -m proteus_tpu_torch.tools.bench [--size 3660] [--iters 4]
        [--passes 3] [--tiles-per-dispatch 2] [--float] [--device cuda]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from proteus_tpu_torch.core.thresholds import HlsThresholds
from proteus_tpu_torch.device import resolve_device
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.ops.wtr_kernel import wtr_layers_batched
from proteus_tpu_torch.tools.kernel_profile import timed_passes


def _oracle():
    """``tests/oracle.py`` of the checkout around this package (NumPy and
    SciPy only), loaded by its path; ``sys.path`` stays as it is."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'tests', 'oracle.py')
    if not os.path.isfile(path):
        raise RuntimeError(f'the NumPy baseline needs {path}: run the '
                           f'bench from a checkout')
    spec = importlib.util.spec_from_file_location('oracle', path)
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--iters', type=int, default=4)
    ap.add_argument('--passes', type=int, default=3)
    ap.add_argument('--tiles-per-dispatch', type=int, default=2)
    ap.add_argument('--float', action='store_true', dest='bench_float',
                    help='scaled-reflectance (float32) bands')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    oracle = _oracle()

    H = W = args.size
    rng = np.random.default_rng(0)
    bands = [np.clip(rng.integers(-2000, 15000, (H, W)), 1,
                     None).astype(np.int16) for _ in range(6)]
    fmask = rng.integers(0, 256, (H, W)).astype(np.uint8)
    invalid = rng.random((H, W)) < 0.02

    # --- baseline: reference-equivalent NumPy float64 chain ----------------
    t = HlsThresholds()
    tdict = {k: getattr(t, k) for k in t.__dataclass_fields__}
    lists = {0: [224, 160, 96], 2: [224, 160, 96],
             3: [224, 192, 160, 128, 96], 4: [224, 192, 160, 128, 96]}
    t0 = time.time()
    oracle.full_chain(*bands, fmask, invalid, tdict, mode='mask',
                      aerosol_lists=lists)
    baseline_s = time.time() - t0
    baseline_tiles_per_min = 60.0 / baseline_s

    # --- device: K dispatches of B distinct tiles ---------------------------
    if args.bench_float:
        bands = [np.float32(0.0001) * b.astype(np.float32) for b in bands]
    # B distinct tiles a dispatch: band-rolled copies, so each tile is
    # distinct without holding B full host copies
    B = args.tiles_per_dispatch
    dev = [torch.from_numpy(np.stack([np.roll(a, i, axis=0)
                                      for i in range(B)])).to(device)
           for a in bands + [fmask, invalid]]
    config = DswxChainConfig()

    def dispatch(*a):
        return wtr_layers_batched(*a, config, compute_browse=True)

    _, per_dispatch = timed_passes(dispatch, dev, args.iters, args.passes,
                                   device)
    per_tile = sorted(s / B for s in per_dispatch)
    device_s = per_tile[len(per_tile) // 2]  # median of the passes
    tiles_per_min = 60.0 / device_s

    record = {
        'metric': f'full_chain_tiles_per_min_{H}x{W}',
        'value': tiles_per_min,
        'unit': 'tiles/min',
        'vs_baseline': tiles_per_min / baseline_tiles_per_min,
        'path': 'cuda' if device.type == 'cuda' else 'plain',
        'tiles_per_dispatch': B,
        'n_passes': args.passes,
        'pass_s_per_tile': per_tile,
        'baseline_s_per_tile': baseline_s,
        'device': (torch.cuda.get_device_name(device)
                   if device.type == 'cuda' else 'cpu'),
    }
    if args.bench_float:
        record['scaled_float_inputs'] = True
    print(json.dumps(record), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
