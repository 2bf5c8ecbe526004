"""Campaign soak: an injected reader fault, a SIGKILL mid-campaign, a resume.

The twin of ``tools/campaign_soak.py`` for the PyTorch port. It proves the
campaign's failure handling on a real device:

  1. ``--tiles`` synthetic HLS tiles sharing one grid and one ancillary set
     (the time-series pattern), written once under ``--root``;
  2. phase A: ``python -m proteus_tpu_torch.cli.dswx_campaign`` in a
     process of its own on ``--device`` (``PROTEUS_TPU_TORCH_DEVICE``), with
     a transient reader fault on ``--fault-tile`` (default tile_03, or the
     last tile of fewer; ``PROTEUS_TPU_FAULT_INJECT=<tile>:1``), SIGKILLed
     as soon as the manifest, polled every 10 ms, shows
     ``--kill-after-done`` tiles done;
  3. phase B: the same command again without the fault: the manifest
     resume must skip every tile done and finish the rest;
  4. the checks: every tile done; the files of the tiles phase A finished
     untouched by phase B (their mtimes); the faulted tile done; every COG
     valid (``io/validate_cog.py``); the same count of ``.tif`` files in
     every tile.

It also reports whether the kill landed mid-campaign (phase A killed with
tiles left), how many reads of the faulted tile failed in each phase as
the logs show and in which phase it was done (a kill before its retry
leaves the retry to phase B), and phase B's campaign statistics with the
per-stage core-seconds (``PROTEUS_TPU_STAGE_TIMES=1``), and the COG codec
the checkout loads (``native.codec()``). Both phases' output goes to logs
under the root. One JSON line; exit 0 on 'pass', 1 on 'FAIL'.

Usage:
    python -m proteus_tpu_torch.tools.campaign_soak [--tiles 32]
        [--size 3660] [--kill-after-done 6] [--fault-tile TILE]
        [--scaled] [--otsu] [--timeout 3600] [--root DIR] [--out PATH]
        [--device cuda]

``--root`` holds the inputs, products and logs (default: a temporary
directory, removed at the end; a named root is kept, and its inputs are
reused). ``--out`` writes the report there; without it no file is written.
"""

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from proteus_tpu_torch.tools import datasets

# the checkout (or site-packages) directory that holds proteus_tpu_torch
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the campaign marks tiles done in bursts: on an H100 all 6 tiles of a
# 3660^2 soak were marked within 0.2-0.26 s of each other (three runs), so
# a coarser poll can see the first mark and the last at once
POLL_S = 0.01


def build_dataset(root, n_tiles, size):
    """``n_tiles`` tiles on one grid and its ancillaries under ``root``:
    (tile directories, ancillary keywords)."""
    dirs = []
    for t in range(n_tiles):
        d = os.path.join(root, f'tile_{t:02d}')
        datasets.write_once(d, '.done', lambda d=d, t=t: datasets.write_tile(
            d, size, seed=9000 + t))
        dirs.append(d)
    anc = os.path.join(root, 'anc')
    datasets.write_once(anc, '.done',
                        lambda: datasets.write_ancillaries(anc, size))
    return dirs, datasets.ancillary_files(anc)


def manifest_state(path):
    """The manifest's entries, {} while it is absent."""
    if not os.path.isfile(path):
        return {}
    with open(path) as fh:
        return json.load(fh)  # written by os.replace: never half a file


def manifest_counts(path):
    counts = {}
    for entry in manifest_state(path).values():
        s = entry.get('status', '?')
        counts[s] = counts.get(s, 0) + 1
    return counts


def failed_reads(log, tile):
    """The reads of ``tile`` that failed, as the campaign logged them."""
    with open(log, errors='replace') as fh:
        return sum(f'tile {tile} read failed' in line for line in fh)


def _tail(log):
    with open(log, errors='replace') as fh:
        return fh.read()[-4000:]


def phase_a(cmd, env, cwd, log, manifest, kill_after_done, timeout):
    """Run the campaign until the manifest shows ``kill_after_done`` tiles
    done, then SIGKILL it; returns (seconds, killed)."""
    t0 = time.perf_counter()
    with open(log, 'wb') as log_fh:
        proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=log_fh,
                                stderr=subprocess.STDOUT)
        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > timeout:
                    raise RuntimeError(f'phase A ran past {timeout} s; log '
                                       f'tail:\n{_tail(log)}')
                if manifest_counts(manifest).get('done', 0) \
                        >= kill_after_done:
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    return time.perf_counter() - t0, True
                time.sleep(POLL_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return time.perf_counter() - t0, False


def soak(args, root, device_name):
    """Phases A and B and the checks; returns the report."""
    from proteus_tpu_torch import native
    report = {'generated': time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                         time.gmtime()),
              'device': device_name, 'codec': native.codec(),
              'tiles': args.tiles, 'size': args.size,
              'scaled': args.scaled, 'otsu': args.otsu,
              'kill_after_done': args.kill_after_done}
    dirs, anc = build_dataset(root, args.tiles, args.size)
    out_dir = os.path.join(root, 'out')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    manifest = os.path.join(out_dir, 'campaign_manifest.json')
    stats_json = os.path.join(out_dir, 'campaign_stats.json')
    cmd = [sys.executable, '-m', 'proteus_tpu_torch.cli.dswx_campaign',
           *dirs, '-o', out_dir, '--dem', anc['dem_file'], '--landcover',
           anc['landcover_file'], '--worldcover', anc['worldcover_file'],
           '--shoreline', anc['shoreline_shapefile'], '--browse',
           '--manifest', manifest, '--stats-json', stats_json]
    if args.scaled:
        cmd.append('--scaled')
    if args.otsu:
        cmd += ['--shadow-masking-algorithm', 'otsu']
    env = dict(os.environ, PROTEUS_TPU_FAULT_INJECT=f'{args.fault_tile}:1',
               PROTEUS_TPU_STAGE_TIMES='1',
               PROTEUS_TPU_TORCH_DEVICE=args.device,
               PYTHONPATH=os.pathsep.join(
                   [_PACKAGE_ROOT] + [p for p in os.environ.get(
                       'PYTHONPATH', '').split(os.pathsep) if p]))

    # ---- phase A: the injected fault, then a SIGKILL mid-campaign ----
    log_a = os.path.join(root, 'phase_a.log')
    seconds, killed = phase_a(cmd, env, root, log_a, manifest,
                              args.kill_after_done, args.timeout)
    state_a = manifest_state(manifest)
    if not state_a:
        raise RuntimeError(f'phase A wrote no manifest ({seconds:.1f} s); '
                           f'log tail:\n{_tail(log_a)}')
    counts_a = manifest_counts(manifest)
    # the mtimes of the tiles phase A finished; a tile that was being
    # written at the kill is rightly written again
    done_a = {t for t, e in state_a.items() if e.get('status') == 'done'}
    mtimes_a = {f: os.path.getmtime(f) for t in done_a
                for f in glob.glob(os.path.join(out_dir, t, '*.tif'))}
    report['phase_a'] = {
        'seconds': seconds, 'killed': killed,
        'killed_mid_campaign': killed
        and counts_a.get('done', 0) < args.tiles,
        'manifest_counts': counts_a, 'files_written': len(mtimes_a)}

    # ---- phase B: the resume, without the fault ----
    del env['PROTEUS_TPU_FAULT_INJECT']
    log_b = os.path.join(root, 'phase_b.log')
    t0 = time.perf_counter()
    with open(log_b, 'wb') as log_fh:
        rc = subprocess.run(cmd, env=env, cwd=root, stdout=log_fh,
                            stderr=subprocess.STDOUT,
                            timeout=args.timeout).returncode
    counts_b = manifest_counts(manifest)
    report['phase_b'] = {'seconds': time.perf_counter() - t0,
                         'returncode': rc, 'manifest_counts': counts_b}
    if os.path.isfile(stats_json):
        with open(stats_json) as fh:
            report['phase_b']['campaign_stats'] = json.load(fh)

    state = manifest_state(manifest)
    fault_done = state.get(args.fault_tile, {}).get('status') == 'done'
    failed = [failed_reads(log, args.fault_tile) for log in (log_a, log_b)]
    report['fault'] = {
        'tile': args.fault_tile, 'failed_reads_phase_a': failed[0],
        'failed_reads_phase_b': failed[1],
        'done_in_phase': ('a' if args.fault_tile in done_a
                          else 'b' if fault_done else None),
        'attempts': sum(failed) + 1 if fault_done else None}

    # ---- the checks ----
    from proteus_tpu_torch.io.validate_cog import validate_cog
    checks = {'all_done': counts_b.get('done', 0) == args.tiles,
              'phase_a_outputs_untouched': all(
                  os.path.getmtime(f) == t for f, t in mtimes_a.items()),
              'fault_tile_done': fault_done}
    cogs = glob.glob(os.path.join(out_dir, 'tile_*', '*.tif'))
    n_bad = sum(bool(validate_cog(f, full_check=False)) for f in cogs)
    checks['cogs_valid'] = n_bad == 0
    checks['n_products_validated'] = len(cogs) - n_bad
    per_tile = {len(glob.glob(os.path.join(d_out, '*.tif')))
                for d_out in (os.path.join(out_dir, os.path.basename(d))
                              for d in dirs)}
    checks['per_tile_tif_count'] = sorted(per_tile)
    report['checks'] = checks
    ok = (checks['all_done'] and checks['phase_a_outputs_untouched']
          and fault_done and checks['cogs_valid'] and len(per_tile) == 1)
    report['status'] = 'pass' if ok else 'FAIL'
    if not ok:
        print(f'phase B log tail:\n{_tail(log_b)}', file=sys.stderr)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tiles', type=int, default=32)
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--kill-after-done', type=int, default=6,
                    help='SIGKILL phase A once this many tiles are done')
    ap.add_argument('--fault-tile', default=None,
                    help='default: tile_03, or the last tile of fewer')
    ap.add_argument('--scaled', action='store_true',
                    help='soak the scaled-reflectance campaign')
    ap.add_argument('--otsu', action='store_true',
                    help='soak the campaign with '
                         '--shadow-masking-algorithm otsu')
    ap.add_argument('--timeout', type=int, default=3600,
                    help='seconds each phase may take')
    ap.add_argument('--root', default=None)
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    tile_ids = [f'tile_{t:02d}' for t in range(args.tiles)]
    if args.fault_tile is None:
        args.fault_tile = tile_ids[min(3, args.tiles - 1)]
    if args.fault_tile not in tile_ids:
        raise ValueError(f'--fault-tile {args.fault_tile} is none of the '
                         f'{args.tiles} tiles')
    from proteus_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    if device.type == 'cuda':
        import torch
        name = torch.cuda.get_device_name(device)
    else:
        name = 'cpu'
    root = args.root or tempfile.mkdtemp(prefix='proteus_soak_')
    try:
        report = soak(args, root, name)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(report, fh, indent=1)
    print(json.dumps({'soak': report['status'], 'device': name,
                      'scaled': args.scaled,
                      'phase_a_s': report['phase_a']['seconds'],
                      'phase_b_s': report['phase_b']['seconds'],
                      'killed_mid_campaign':
                          report['phase_a']['killed_mid_campaign'],
                      'fault': report['fault'], 'checks': report['checks'],
                      'artifact': args.out}), flush=True)
    return 0 if report['status'] == 'pass' else 1


if __name__ == '__main__':
    sys.exit(main())
