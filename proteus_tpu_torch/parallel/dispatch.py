"""Multi-host campaign dispatch (``dswx_campaign --hosts N``).

Port of ``proteus_tpu/parallel/dispatch.py``. The single-host
CampaignRunner splits a tile batch over one host's GPUs. This module
scales the campaign across hosts: tiles are deterministically partitioned
per host, each host runs its own CampaignRunner against a per-host
manifest shard (single-writer ledgers: no cross-host file locking, works
on shared filesystems and object stores), and the dispatcher merges the
shards, re-runs the tiles of dead or straggling hosts, and reports the
campaign statistics.

``dispatch_campaign`` is the local dispatcher: it spawns one worker
subprocess a simulated host (``python -m proteus_tpu_torch.parallel.dispatch
<spec>``) and supervises them. Where the reference's spec names a JAX
platform, the port's names the worker's devices: ``device`` is the device
spec the dispatcher was given (``PROTEUS_TPU_TORCH_DEVICE``: ``cuda``,
``cuda:N`` or ``cpu``; the worker makes it its ``PROTEUS_TPU_TORCH_DEVICE``)
and ``devices`` the worker's own share of it. Workers of one machine share
its cards: with ``cuda``, card c goes to worker c mod n_workers, so no two
workers both take every card; with fewer cards than workers (one card, or
``cuda:N``) workers share a card.
"""

import json
import logging
import os
import subprocess
import sys

from proteus_tpu_torch.parallel.campaign import CampaignManifest, TileJob

logger = logging.getLogger('dswx_hls')

_JOB_FIELDS = ('tile_id', 'input_files', 'output_dir', 'product_id',
               'product_version', 'dem_file', 'landcover_file',
               'worldcover_file', 'shoreline_shapefile',
               'ocean_masking_shoreline_distance_km')


def host_shard(jobs, process_index, process_count):
    """Deterministic round-robin partition of jobs for one host.

    Round-robin (not contiguous chunks) so geographic batches, which
    correlate with ancillary-warp cost, spread evenly across hosts.
    """
    return [j for k, j in enumerate(jobs)
            if k % process_count == process_index]


def host_manifest_path(manifest_path, process_index):
    root, ext = os.path.splitext(manifest_path)
    return f'{root}.host{process_index}{ext or ".json"}'


def merge_manifests(manifest_path, process_count):
    """Merge per-host manifest shards into one CampaignManifest state."""
    merged = CampaignManifest(None)
    for k in range(process_count):
        shard = CampaignManifest(host_manifest_path(manifest_path, k))
        for tile_id, entry in shard.state.items():
            cur = merged.state.get(tile_id)
            if cur is None or entry.get('status') == 'done':
                merged.state[tile_id] = entry
    return merged


def job_to_dict(job):
    return {f: getattr(job, f) for f in _JOB_FIELDS}


def job_from_dict(d):
    return TileJob(**d)


def worker_devices(device, worker_index, n_workers, n_cards=None):
    """The devices of worker ``worker_index`` of ``n_workers`` on this
    machine, as device names, from the device spec ``device``: ``cpu`` and
    ``cuda:N`` are every worker's; ``cuda`` (every visible card, ``n_cards``
    of them; default ``torch.cuda.device_count()``) gives card c to worker
    c mod n_workers, and a worker left with none (more workers than cards)
    shares card ``worker_index mod n_cards``."""
    if device != 'cuda':
        return [device]
    if n_cards is None:
        import torch
        n_cards = torch.cuda.device_count()
    if n_cards < 1:
        raise RuntimeError("device 'cuda' was requested but no CUDA device "
                           "is visible")
    cards = [c for c in range(n_cards) if c % n_workers == worker_index] \
        or [worker_index % n_cards]
    return [f'cuda:{c}' for c in cards]


def run_host_worker(spec_path):
    """Entry point of one host worker: process the spec's job list on the
    spec's devices. The spec's device spec becomes this process's
    ``PROTEUS_TPU_TORCH_DEVICE`` before anything reads it."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    os.environ['PROTEUS_TPU_TORCH_DEVICE'] = spec['device']
    from proteus_tpu_torch.device import resolve_device
    from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
    from proteus_tpu_torch.parallel.campaign import CampaignRunner
    jobs = [job_from_dict(d) for d in spec['jobs']]
    for j in jobs:
        os.makedirs(j.output_dir, exist_ok=True)
    runner = CampaignRunner(
        config=DswxChainConfig(**spec.get('config_kwargs', {})),
        mesh=[resolve_device(d) for d in spec['devices']],
        manifest_path=spec['manifest_path'],
        save_browse=spec.get('save_browse', False),
        **spec.get('runner_kwargs', {}))
    stats = runner.run(jobs)
    print(json.dumps({'worker_stats': stats}))
    return 0 if stats['tiles_failed'] == 0 else 1


def dispatch_campaign(jobs, n_hosts, manifest_path, scratch_dir,
                      config_kwargs=None, save_browse=False,
                      device='cuda', timeout=3600, max_host_failures=1,
                      runner_kwargs=None):
    """Run a campaign across ``n_hosts`` worker processes.

    Each worker gets a deterministic shard, its own manifest file and its
    share of ``device`` (``worker_devices``). After all workers exit, tiles
    that are not 'done' (worker crashes, lost or hung hosts, the latter
    killed after ``timeout``) are re-run by one worker up to
    ``max_host_failures`` times. ``runner_kwargs`` (spatial_shards,
    tiles_per_device, flag_debug, reader/writer threads, ...) pass through
    to every worker's CampaignRunner. Returns the merged manifest and
    aggregate statistics.
    """
    os.makedirs(scratch_dir, exist_ok=True)

    def launch(pending_jobs, n_workers, round_idx):
        procs = []
        for k in range(n_workers):
            shard = host_shard(pending_jobs, k, n_workers)
            if not shard:
                continue
            spec = {
                'jobs': [job_to_dict(j) for j in shard],
                'manifest_path': host_manifest_path(manifest_path, k),
                'config_kwargs': config_kwargs or {},
                'save_browse': save_browse,
                'device': device,
                'devices': worker_devices(device, k, n_workers),
                'runner_kwargs': runner_kwargs or {},
            }
            spec_path = os.path.join(scratch_dir,
                                     f'host{k}_r{round_idx}.json')
            with open(spec_path, 'w') as fh:
                json.dump(spec, fh)
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'proteus_tpu_torch.parallel.dispatch',
                 spec_path]))
        for p in procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                # straggler/hung host: kill it and let the recovery
                # rounds below re-run its unfinished tiles
                logger.error(f'worker pid {p.pid} exceeded {timeout}s; '
                             'killing (tiles will be reassigned)')
                p.kill()
                p.wait()

    launch(jobs, n_hosts, 0)
    merged = merge_manifests(manifest_path, n_hosts)

    for round_idx in range(1, max_host_failures + 1):
        pending = [j for j in jobs
                   if merged.state.get(j.tile_id, {}).get('status')
                   != 'done']
        if not pending:
            break
        # survivors re-run the lost tiles (single worker is enough for
        # the recovery pass; tiles are independent)
        launch(pending, 1, round_idx)
        merged = merge_manifests(manifest_path, n_hosts)

    done = sum(1 for e in merged.state.values()
               if e.get('status') == 'done')
    failed = sum(1 for e in merged.state.values()
                 if e.get('status') == 'failed')
    return merged, {'tiles_done': done, 'tiles_failed': failed,
                    'tiles_total': len(jobs)}


if __name__ == '__main__':
    sys.exit(run_host_worker(sys.argv[1]))
