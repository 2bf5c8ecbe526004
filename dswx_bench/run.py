"""Run one cell of the benchmark once.

    python -m dswx_bench --workload <name> --seed <n> --seconds <s> --trace 0|1

from the root of a checkout on a machine with the cards the cell asks for.
The cell's configuration and traffic mix are found by the names in
``BENCHMARK.json`` (``registry.py``). Set-up makes the inputs from the seed
(``generate.py``) and warms up every shape the window uses through the
configuration's entry (``entries/``); the window then drives the entry for
``--seconds`` and ends with its last whole pass or product. With
``--trace 1`` the window runs under ``torch.profiler`` and the run reports
the per-layer metrics and the breakdown, else the end-to-end metrics; each
metric is read by ``metrics/<name>.py``. After the window a sample of the
products drawn from the seed is held to the plain reference
(``reference/``). The last line of standard output is the result's JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

Everything the run writes is under ``build/dswx_bench/`` of the checkout:
its inputs and products (removed at the end), the trace, and the cache
directories a compiler would use. The program builds its own kernels and
codec into ``build/`` at fixed paths, so only a checkout's first run
builds.
"""

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from dswx_bench import registry

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'proteus_tpu')
WORK = os.path.join(registry.ROOT, 'build', 'dswx_bench')
SEED_MOD = 2 ** 63


def forbidden_modules(names=None):
    """The top-level names of ``names`` (default: ``sys.modules``) that the
    port must not load, compared whole (``proteus_tpu_torch`` is not
    ``proteus_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split('.')[0] for m in names} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fixed_cache_dirs(work=WORK):
    """Compiler caches at fixed paths inside the checkout."""
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(work, 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(work, 'triton')


def sample(products, k, seed):
    """``k`` of ``products`` drawn from the seed, the last one always among
    them (the answer due last in the window)."""
    import numpy as np
    if len(products) <= k:
        return list(products)
    rng = np.random.default_rng(seed % SEED_MOD)
    rest = rng.choice(len(products) - 1, size=k - 1, replace=False)
    return [products[i] for i in sorted(rest)] + [products[-1]]


def _card():
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = 'unknown'
    return name, limit


def _dir_bytes(path):
    total = 0
    for base, _, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(base, f))
            except OSError:
                pass
    return total


def _product_bytes(product):
    """{file name past the product's prefix: bytes} of one product's
    layers and browse, as written."""
    directory, prefix, _ = product
    return {f[len(prefix):]: os.path.getsize(os.path.join(directory, f))
            for f in sorted(os.listdir(directory)) if f.startswith(prefix)}


def check(inputs, products, processing, failed):
    """The numbers compared: {check: value} over the sampled products."""
    from dswx_bench.reference import compare
    from dswx_bench.reference.products import grid_layers, product
    distinct = {a.name: a for _, _, a in products}
    grids = {}
    for a in distinct.values():
        grids.setdefault(a.grid['geotransform'], a.grid)

    def one(item):
        directory, prefix, acquisition = item
        return compare.compare(compare.read_product(directory, prefix),
                               want[acquisition.name])

    with ThreadPoolExecutor(max(1, len(distinct))) as pool:
        shared = dict(zip(grids, pool.map(
            lambda grid: grid_layers(inputs, grid, processing),
            grids.values())))
        want = dict(zip(distinct, pool.map(
            lambda a: product(a, shared[a.grid['geotransform']],
                              processing), distinct.values())))
        readings = list(pool.map(one, products))
    out = compare.worst(readings)
    out['failed_tiles'] = failed
    return out


def run_cell(workload, seed, seconds, traced, device, bench=None,
             config=None, mix=None, work=WORK, t_start=None):
    """One run of ``workload``: (result dict, earlier lines). ``config`` and
    ``mix`` stand in for the cell's files (the CPU tests' small sizes)."""
    import torch
    from dswx_bench import entries, generate
    from dswx_bench import trace as tr
    from dswx_bench.reference.compare import LIMITS
    from dswx_bench.reference.products import check_supported
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or registry.benchmark()
    cell = registry.cell(bench, workload)
    config = config or registry.config(cell['config'])
    mix = mix or registry.traffic(cell['traffic'])
    check_supported(config)
    device = torch.device(device)
    on_cuda = device.type == 'cuda'
    run_dir = os.path.join(work, 'run')
    shutil.rmtree(run_dir, ignore_errors=True)
    lines = []
    # the entry imports the program: a checkout without it stops here
    entry_class = entries.load(config['entry'])
    try:
        inputs = generate.make_inputs(config, mix, seed % SEED_MOD,
                                      os.path.join(run_dir, 'inputs'),
                                      device)
        input_bytes = _dir_bytes(run_dir)
        spans = tr.HostSpans() if traced else None
        entry = entry_class(config, mix, inputs, run_dir, device, spans)
        entry.warm_up()
        if on_cuda:
            torch.cuda.synchronize(device)
        # the warm-up's products go before the kernel writes them back
        # (the inputs were put on the disk as they were made), so no
        # write of set-up's lands in the window
        shutil.rmtree(os.path.join(run_dir, 'out'), ignore_errors=True)
        setup_s = time.perf_counter() - t_start
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(device)
        trace_path = os.path.join(work, 'trace.json')
        if traced:
            with tr.profiled(trace_path, spans):
                window = entry.window(seconds)
        else:
            window = entry.window(seconds)
        if on_cuda:
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
        found = forbidden_modules()
        if found:
            raise SystemExit(f'the process loaded {", ".join(found)}')
        record = {'cell': workload, 'chips': cell['chips'], 'setup_s': setup_s,
                  'peak_bytes': peak, 'grid': inputs.grid,
                  'ancillaries': {k: (v[1].shape, v[2], v[1].itemsize)
                                  for k, v in inputs.ancillaries.items()},
                  'processing': config['processing'],
                  'stage_seconds': getattr(entry, 'stage_seconds', None),
                  'stage_timers': getattr(entry, 'stage_timers', None),
                  'trace': None, **window}
        if traced:
            w, device_ops, program_spans = tr.read_trace(trace_path)
            record['trace'] = {'window': w, 'device': device_ops,
                               'spans': program_spans + spans.on_trace(w)}
        misses = getattr(entry, 'misses', None)
        if misses is not None:
            lines.append({'ancillary_cache_misses': misses})
        lines.append({'window': window,
                      'stage_timers': record['stage_timers'],
                      'stage_seconds': record['stage_seconds']})
        products = entry.products
        entry.close()
        del entry
        gc.collect()
        if on_cuda:
            torch.cuda.empty_cache()
        sampled = sample(products, mix['sample_products'], seed)
        t0 = time.perf_counter()
        checks = check(inputs, sampled, config['processing'],
                       window['failed'])
        lines.append({'reference_s': time.perf_counter() - t0,
                      'sampled': len(sampled)})
        # what the run wrote: its inputs, products and trace (the
        # campaign's manifest, rewritten after every tile, counts once)
        lines.append({'product_file_bytes': _product_bytes(products[-1])})
        lines.append({
            'bytes_written': _dir_bytes(run_dir) + (
                os.path.getsize(trace_path) if traced else 0),
            'input_bytes': input_bytes, 'host_cores': os.cpu_count(),
            'codec': _codec()})
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    metrics = {}
    for m in registry.metrics_of(bench, workload, traced):
        value = registry.reader(m['name'])(record)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    result = {'correct': all(checks[k] <= LIMITS[k] for k in LIMITS),
              'attempted': window['attempted'], 'failed': window['failed'],
              'metrics': metrics}
    if on_cuda:
        name, limit = _card()
        lines.append({'card': name, 'power_limit': limit})
        result['device'] = {'platform': 'gpu', 'kind': name,
                            'count': cell['chips'], 'memory_peak_bytes': peak}
    else:
        result['device'] = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                            'memory_peak_bytes': 0}
    if traced:
        t = record['trace']
        w = t['window']
        share = tr.busy_share([(ts, ts + dur) for _, ts, dur in t['device']],
                              w)
        result['device'].update(busy_s=share['busy'] * 1e-6,
                                window_s=share['window'] * 1e-6)
        result['breakdown'] = {
            'device_ops': tr.top_operations(t['device']),
            'idle_gaps': tr.idle_gaps(t['device'], t['spans'], w)}
    result['checks'] = {k: {'value': checks[k], 'limit': LIMITS[k]}
                        for k in LIMITS}
    return result, lines


def _codec():
    from proteus_tpu_torch import native
    return native.codec()


def main(argv=None):
    t_start = time.perf_counter()
    args = parse(argv)
    import torch
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell['chips']:
        print(f'{args.workload} needs {cell["chips"]} CUDA device(s); '
              f'torch.cuda.is_available() is {torch.cuda.is_available()}, '
              f'{torch.cuda.device_count()} seen', file=sys.stderr)
        return 2
    fixed_cache_dirs()
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), 'cuda', bench=bench,
                             t_start=t_start)
    for line in lines:
        print(json.dumps(line), flush=True)
    for name, c in result['checks'].items():
        print(f'check {name} {c["value"]} limit {c["limit"]}',
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
