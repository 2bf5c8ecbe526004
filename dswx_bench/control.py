"""The control of ``correct``: the plain reference put in the program's
place at the precision below the one the science states.

    python -m dswx_bench.control --workload <name> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs (the arrays alone, no files) at
the cell's own size, works out the products of the first acquisitions a
run samples twice, in float64 (the reference) and in float32 (the control:
the warp's interpolation and the shadow's geometry), and prints one JSON
line of the numbers ``correct`` compares, read for the control. A control
that passes every limit would show the comparison blind to a lower
precision; each line says whether it failed one. It runs on the card
where there is one (the generator's device) and on the host otherwise;
the benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time

import numpy as np

from dswx_bench import generate, registry
from dswx_bench.reference import compare
from dswx_bench.reference.products import grid_layers, product


def readings(config, mix, seed, device):
    """{check: pixels the float32 control differs from the float64
    reference in}, the most over the sampled acquisitions."""
    inputs = generate.make_inputs(config, mix, seed, None, device,
                                  write=False)
    p = config['processing']
    out = []
    grids = {}
    for a in inputs.acquisitions[:mix['sample_products']]:
        key = a.grid['geotransform']
        if key not in grids:
            grids[key] = (grid_layers(inputs, a.grid, p),
                          grid_layers(inputs, a.grid, p, work=np.float32))
        want_grid, got_grid = grids[key]
        out.append(compare.compare(product(a, got_grid, p, np.float32),
                                   product(a, want_grid, p)))
    worst = compare.worst(out)
    worst.pop('failed_tiles')
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    import torch
    device = 'cuda' if torch.cuda.is_available() else 'cpu'
    cell = registry.cell(registry.benchmark(), args.workload)
    config = registry.config(cell['config'])
    mix = registry.traffic(cell['traffic'])
    failed_all = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(config, mix, seed, device)
        failed = any(v > compare.LIMITS[k] for k, v in r.items())
        failed_all &= failed
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'control_readings': r, 'control_fails': failed,
                          'seconds': time.perf_counter() - t0}), flush=True)
    return 0 if failed_all else 1


if __name__ == '__main__':
    sys.exit(main())
