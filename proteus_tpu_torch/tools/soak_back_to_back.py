"""The integer and the scaled campaign soaks back to back, in one session.

The twin of ``tools/soak_back_to_back.py`` for the PyTorch port: the soak
of ``tools/campaign_soak.py`` on int16 bands, then with ``--scaled`` (then
on int16 bands again with ``--abba``, which separates the mode's effect
from drift of the host), over one dataset under ``--root``, so that the
two phase B times compare runs on the same host state. Each soak writes
its report under the root and the driver reads it back only if the soak
passed and the report is fresh (never an earlier session's). One JSON
line with each run's phase A and B seconds, its status, whether its kill
landed mid-campaign, its stage core-seconds, and
``phase_b_scaled_over_int``.

Usage:
    python -m proteus_tpu_torch.tools.soak_back_to_back [--tiles 32]
        [--size 3660] [--kill-after-done 6] [--abba] [--timeout 3600]
        [--root DIR] [--out PATH] [--device cuda]

``--root`` holds the dataset, the soaks' products and reports (default: a
temporary directory, removed at the end; a named root is kept). ``--out``
writes the summary there; without it no file is written.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from proteus_tpu_torch.tools import campaign_soak


def run_one(mode, args, root):
    """One soak (``mode`` 'int', 'scaled' or 'int_again') on the shared
    dataset; returns its report."""
    out = os.path.join(root, f'soak_{mode}.json')
    argv = ['--tiles', str(args.tiles), '--size', str(args.size),
            '--kill-after-done', str(args.kill_after_done),
            '--timeout', str(args.timeout), '--device', args.device,
            '--root', os.path.join(root, 'data'), '--out', out]
    if mode == 'scaled':
        argv.append('--scaled')
    t0 = time.time()
    rc = campaign_soak.main(argv)
    # an earlier session's report must never stand in for this run's
    if rc != 0:
        raise RuntimeError(f'{mode} soak failed (rc={rc}); refusing to '
                           f'read {out}')
    if not os.path.isfile(out) or os.path.getmtime(out) < t0:
        raise RuntimeError(f'{mode} soak wrote no fresh {out} (stale or '
                           'missing report)')
    with open(out) as fh:
        return json.load(fh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tiles', type=int, default=32)
    ap.add_argument('--size', type=int, default=3660)
    ap.add_argument('--kill-after-done', type=int, default=6)
    ap.add_argument('--abba', action='store_true',
                    help='also run the integer soak again after the '
                         'scaled one')
    ap.add_argument('--timeout', type=int, default=3600,
                    help='seconds each phase of a soak may take')
    ap.add_argument('--root', default=None)
    ap.add_argument('--out', default=None)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix='proteus_soak_b2b_')
    summary = {'generated': time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                          time.gmtime()),
               'tiles': args.tiles, 'size': args.size, 'runs': []}
    reports = {}
    try:
        for mode in ['int', 'scaled'] + (['int_again'] if args.abba
                                         else []):
            rep = reports[mode] = run_one(mode, args, root)
            entry = {'mode': mode,
                     'phase_a_s': rep['phase_a']['seconds'],
                     'phase_b_s': rep['phase_b']['seconds'],
                     'status': rep['status'],
                     'killed_mid_campaign':
                         rep['phase_a']['killed_mid_campaign'],
                     'fault': rep['fault']}
            stats = rep['phase_b'].get('campaign_stats', {})
            if stats.get('stage_seconds'):
                entry['stage_seconds'] = stats['stage_seconds']
            summary['runs'].append(entry)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    summary['device'] = reports['int']['device']
    summary['codec'] = reports['int']['codec']
    summary['phase_b_scaled_over_int'] = (
        reports['scaled']['phase_b']['seconds']
        / reports['int']['phase_b']['seconds'])
    if args.abba:
        summary['phase_b_int_again_s'] = \
            reports['int_again']['phase_b']['seconds']
    if args.out:
        with open(args.out, 'w') as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps({'metric': 'soak_phase_b_scaled_over_int',
                      **summary, 'artifact': args.out}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
