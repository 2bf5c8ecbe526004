"""The campaign entry: ``CampaignRunner.run``, as ``dswx_campaign`` runs it.

The window runs whole passes. A pass is one campaign over the mix's
acquisitions, started from cleared ancillary and COG payload caches, as a
new ``dswx_campaign`` process starts. One runner serves every pass, each
pass's tiles under ids of their own in one manifest. With a trace
(``spans``, a ``trace.HostSpans``), the ancillary cache's misses are
counted by kind (the first field of a key), the stage table is switched
on, and the reader, the device step and the writer are wrapped in host
spans.
"""

import contextlib
import os
import threading
import time

from proteus_tpu_torch.core.thresholds import HlsThresholds
from proteus_tpu_torch.io import cog
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.parallel import campaign

from dswx_bench import trace

READ, STEP, WRITE = 'campaign.read_tile', 'campaign.device_step', \
    'campaign.write_tile'


@contextlib.contextmanager
def counting_misses(cache):
    """Count ``cache``'s misses by the first field of their key while the
    block runs (a copy of ``tools/bench_cold_grid.py::counting_misses``);
    yields the counts."""
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


# settings the campaign fixes; a configuration that states another value
# is refused, not run with the program's
FIXED = {'landcover_mask_type': 'standard', 'dem_margin_px': 50,
         'browse_height': 1024, 'browse_width': 1024}
# the chain's aerosol lists, by the WTR-1 class each remaps
_AEROSOL_FIELDS = {'0': 'aerosol_not_water_fmask_values',
                   '2': 'aerosol_moderate_conf_fmask_values',
                   '3': 'aerosol_psw_conservative_fmask_values',
                   '4': 'aerosol_psw_aggressive_fmask_values'}
_CHAIN_KEYS = ('mask_adjacent_to_cloud_mode', 'apply_aerosol_class_remapping',
               'min_slope_angle', 'max_sun_local_inc_angle',
               'shadow_masking_algorithm', 'exclude_psw_aggressive_in_browse',
               'not_water_in_browse', 'cloud_in_browse', 'snow_in_browse')


def chain_config(p):
    """The program's ``DswxChainConfig`` of a configuration's
    ``processing``: every science setting the chain takes."""
    for key, value in FIXED.items():
        if p[key] != value:
            raise ValueError(f'the campaign fixes {key} at {value!r}; the '
                             f'configuration states {p[key]!r}')
    kwargs = {k: p[k] for k in _CHAIN_KEYS}
    kwargs.update({_AEROSOL_FIELDS[k]: tuple(v)
                   for k, v in p['aerosol_lists'].items()})
    return DswxChainConfig(
        thresholds=HlsThresholds(**p['hls_thresholds']),
        forest_mask_landcover_classes=tuple(
            p['forest_mask_landcover_classes']), **kwargs)


class Entry:
    def __init__(self, config, mix, inputs, work, device, spans):
        self.campaign = campaign
        self.inputs = inputs
        self.work = work
        self.spans = spans
        p = config['processing']
        self.version = str(p['product_version'])
        # every option of the runner as the configuration's 'campaign'
        # group names it
        self.runner = campaign.CampaignRunner(
            config=chain_config(p), mesh=[device],
            manifest_path=os.path.join(work, 'manifest.json'),
            save_browse=p['browse'], **config['campaign'])
        self.warmup = mix['warmup_products']
        self.products = []
        self.misses = None
        self.stage_seconds = None

    def _fresh(self):
        """Empty the program's caches, as a new process finds them."""
        for cache in (getattr(self.campaign, 'ANCILLARY_CACHE', None),
                      getattr(cog, 'PAYLOAD_CACHE', None)):
            if cache is not None:
                cache.clear()

    def _jobs(self, label, acquisitions):
        anc = self.inputs.ancillaries
        jobs = []
        for a in acquisitions:
            tile_id = f'{a.name}.{label}'
            out = os.path.join(self.work, 'out', label, tile_id)
            jobs.append(self.campaign.TileJob(
                tile_id, a.files, out, product_id=tile_id,
                product_version=self.version, dem_file=anc['dem'][0],
                landcover_file=anc['cgls'][0],
                worldcover_file=anc['worldcover'][0]))
        return jobs

    def warm_up(self):
        """One campaign over the first acquisitions (a whole pass in the
        cell's mix): every shape and kernel of the window, the caches' miss
        paths, and the host's allocations at their size."""
        self._fresh()
        stats = self.runner.run(self._jobs(
            'warmup', self.inputs.acquisitions[:self.warmup]))
        if stats['tiles_failed']:
            raise RuntimeError(f'warm-up: {stats["tiles_failed"]} tiles '
                               'failed')

    def _passes(self, seconds):
        t0 = time.perf_counter()
        done = failed = attempted = k = 0
        pass_s = []
        while True:
            self._fresh()
            label = f'p{k:03d}'
            jobs = self._jobs(label, self.inputs.acquisitions)
            t = time.perf_counter()
            stats = self.runner.run(jobs)
            pass_s.append(time.perf_counter() - t)
            for job, a in zip(jobs, self.inputs.acquisitions):
                self.products.append(
                    (job.output_dir, f'{job.tile_id}_v{self.version}_', a))
            attempted += len(jobs)
            done += stats['tiles_done']
            failed += stats['tiles_failed']
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return {'window_s': time.perf_counter() - t0, 'products': done,
                'attempted': attempted, 'failed': failed, 'pass_s': pass_s}

    def window(self, seconds):
        if self.spans is None:
            return self._passes(seconds)
        cmod = self.campaign
        enabled = cmod.STAGE_TIMES.enabled
        cmod.STAGE_TIMES.reset()
        cmod.STAGE_TIMES.enabled = True
        cache = getattr(cmod, 'ANCILLARY_CACHE', None)
        counting = counting_misses(cache) if cache is not None \
            else contextlib.nullcontext()
        try:
            with counting as misses, trace.annotate(
                    [(cmod, '_read_tile', READ),
                     (cmod.CampaignRunner, '_run_batch', STEP),
                     (cmod, '_write_tile', WRITE)], self.spans):
                out = self._passes(seconds)
        finally:
            cmod.STAGE_TIMES.enabled = enabled
        self.misses = dict(sorted(misses.items())) if cache is not None \
            else 'not available'
        self.stage_seconds = {k: v[0]
                              for k, v in cmod.STAGE_TIMES.totals.items()}
        return out

    def close(self):
        self._fresh()
        self.runner = None
