"""Campaign mode: batched multi-tile processing over the local GPUs.

Port of ``proteus_tpu/parallel/campaign.py``:

- a batch of whole tiles [B, H, W] is split in order over the devices of
  ``parallel.mesh.make_tile_mesh``; each device runs one
  ``ops.wtr_kernel.wtr_layers_batched`` on its share (kernel slices K4 to
  K6 on CUDA, the plain chain on the CPU) and the campaign totals are
  summed over the devices in Python integers;
- with ``--spatial-shards``, ``make_spatial_campaign_step`` over the rows
  of ``parallel.mesh.make_tile_space_mesh`` also cuts each tile's rows
  over the devices of its row: each shard stages its rows with their halo
  and makes one windowed launch (K6 spatial), and the tile comes back as
  row pieces;
- a host I/O pipeline: a reader thread pool prefetches and decodes the
  next batch of HLS tiles while the devices compute the current one, and
  a writer pool encodes finished COGs;
- a JSON manifest of per-tile status with retry, for failure detection and
  checkpoint/resume of long campaigns.

On CUDA the step ships the minimal outputs (K5: PACKED_A/B, 2 B/px) and
the writer pool derives the dependent layers on the host
(``models/dswx/host_derive.py``); the JAX package's twin of K5's packing,
``_pack_minimal_device``, is ``ops.wtr_kernel.pack_minimal`` here.
"""

import contextlib
import json
import logging
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.ops.wtr_kernel import BANDS, wtr_layers_batched
from proteus_tpu_torch.parallel.mesh import (make_tile_mesh,
                                             make_tile_space_mesh)

logger = logging.getLogger('dswx_hls')

class StageTimes:
    """Cumulative wall-clock per pipeline stage (thread-safe).

    Enabled by PROTEUS_TPU_STAGE_TIMES=1; CampaignRunner.run() returns
    the table under stats['stage_seconds']. Stage seconds are summed
    across pool threads, so they measure CORE-seconds of occupancy (plus
    in-stage waiting, e.g. d2h transfer time inside 'd2h_*'), not
    wall-clock.
    """

    def __init__(self):
        self.enabled = os.environ.get('PROTEUS_TPU_STAGE_TIMES') == '1'
        self._lock = threading.Lock()
        self.totals = {}

    @contextlib.contextmanager
    def stage(self, name):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                cur = self.totals.setdefault(name, [0.0, 0])
                cur[0] += dt
                cur[1] += 1

    def reset(self):
        with self._lock:
            self.totals = {}

    def table(self):
        return {k: {'seconds': round(v[0], 2), 'calls': v[1]}
                for k, v in sorted(self.totals.items(),
                                   key=lambda kv: -kv[1][0])}


STAGE_TIMES = StageTimes()

def pack_bits_device(x):
    """(h, w) 0/1 uint8 -> (h, ceil(w/8)) uint8 bit-packing on the
    tensor's device (little bit order, matching
    np.unpackbits(bitorder='little'))."""
    h, w = x.shape
    pad = (-w) % 8
    xp = torch.nn.functional.pad(x.to(torch.int32), (0, pad))
    xp = xp.reshape(h, -1, 8)
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.int32,
                           device=x.device)
    return (xp * weights).sum(-1).to(torch.uint8)


def _split(arg, devices):
    """A [B, ...] batch as one share a device, in order: a list or tuple
    is taken as the shares already; an array or tensor is cut into
    len(devices) equal parts, each moved to its device."""
    if isinstance(arg, (list, tuple)):
        return [a.to(d) for a, d in zip(arg, devices)]
    t = torch.as_tensor(arg)
    if t.shape[0] % len(devices):
        raise ValueError(f'batch of {t.shape[0]} does not split over '
                         f'{len(devices)} devices')
    return [s.to(d).contiguous()
            for s, d in zip(t.chunk(len(devices)), devices)]


def make_campaign_step(config: DswxChainConfig, devices,
                       compute_browse=False, with_ocean=False,
                       with_shadow=False, with_landcover=False,
                       float_inputs=False, device_scale=False, minimal=None):
    """Build the multi-tile step over ``devices`` (``make_tile_mesh``).

    The returned function maps batched [B, H, W] band/fmask/invalid inputs
    (with ``device_scale``, two [B, 6] float32 inputs after ``invalid``:
    the per-band scales and offsets; then the optional ocean/shadow/
    landcover mask batches) to per-tile output layers and the campaign
    totals. Each input is an array or tensor that is split in order over
    the devices, or a list of their shares. The layers come back as
    ``out[name][k]``, tile k's tensor on its device; the totals as Python
    integers.

    ``float_inputs=True`` is the scaled-reflectance campaign: bands are
    float32 (ingest applied scale/offset). ``device_scale=True`` (requires
    float_inputs): bands arrive as RAW int16 with the scales and offsets
    and the cast ``scale * (float32(band) - offset)`` runs on the device,
    inside the kernel on CUDA (K4). ``minimal`` (default: the devices are
    CUDA) returns PACKED_A/PACKED_B (K5) in place of the full layers.
    """
    if device_scale and not float_inputs:
        raise ValueError('device_scale requires float_inputs=True '
                         '(it feeds the float32 science chain)')
    devices = list(devices)
    if minimal is None:
        minimal = all(d.type == 'cuda' for d in devices)
    n_lead = 10 if device_scale else 8

    def local_step(b, g, r, n, s1, s2, fm, inv, *rest):
        scales = offsets = None
        if device_scale:
            scales, offsets, *rest = rest
        it = iter(rest)
        ocean = next(it) if with_ocean else None
        shadow = next(it) if with_shadow else None
        lc = next(it) if with_landcover else None
        # the layers and each tile's coverage counts, valid pixels also
        # not ocean (campaign.py:218-231), which the kernel adds up as it
        # goes
        out = wtr_layers_batched(
            b, g, r, n, s1, s2, fm, inv, config, scales=scales,
            offsets=offsets, ocean=ocean, shadow=shadow, landcover=lc,
            compute_browse=compute_browse, minimal=minimal)
        # (JAX's n_not_ocean count is left out: no total reads it)
        del out['n_not_ocean']
        return out

    def step(*args):
        n_in = n_lead + int(with_ocean) + int(with_shadow) \
            + int(with_landcover)
        if len(args) != n_in:
            raise ValueError(f'campaign step: {len(args)} inputs, expected '
                             f'{n_in}')
        shares = [_split(a, devices) for a in args]
        outs = [local_step(*[s[k] for s in shares])
                for k in range(len(devices))]
        out = {name: [t for o in outs for t in o[name]] for name in outs[0]}
        # a device's two totals in one read, which waits for its launches
        sums = [torch.stack([o['n_valid'].sum(), o['n_cloud_and_valid'].sum()])
                .tolist() for o in outs]
        totals = {
            'n_valid_total': sum(v for v, _ in sums),
            'n_cloud_and_valid_total': sum(c for _, c in sums),
            'n_tiles_total': sum(int(s.shape[0]) for s in shares[0]),
        }
        return out, totals

    return step


# influence radius of the 'cover'-mode snow dilation chain: 10 iterations
# of snow dilation followed by 7 iterations of not-water dilation
SPATIAL_HALO = 17


def _shape(arg):
    if isinstance(arg, (list, tuple)):
        return (len(arg),) + tuple(arg[0].shape)
    return tuple(arg.shape)


def _tile_rows(arg, tiles, rows, device):
    """Rows ``rows`` of the tiles ``tiles`` (two slices) of a [B, H, W]
    input as one contiguous tensor on ``device``. ``arg`` is an array or
    tensor, or a list of per-tile (H, W) arrays or tensors; a tile that
    lies on another card is copied from there."""
    if isinstance(arg, (list, tuple)):
        return torch.stack([torch.as_tensor(a)[rows].to(device)
                            for a in arg[tiles]])
    return torch.as_tensor(arg)[tiles, rows].to(device).contiguous()


def make_spatial_campaign_step(config: DswxChainConfig, mesh,
                               halo=SPATIAL_HALO, compute_browse=False,
                               with_ocean=False, with_shadow=False,
                               with_landcover=False, float_inputs=False,
                               device_scale=False):
    """Build the spatially sharded step over ``mesh``, rows of devices
    (``make_tile_space_mesh``): a batch's tiles are split in order over
    the rows, and each tile's H rows over the n devices of its row, shard
    j holding rows [j H/n, (j + 1) H/n).

    Its inputs are ``make_campaign_step``'s: [B, H, W] bands, fmask and
    invalid (with ``device_scale``, the [B, 6] float32 scales and offsets
    after ``invalid``, raw int16 bands), then the optional ocean, shadow
    and landcover; each an array or tensor, or a list of per-tile (H, W)
    arrays or tensors (a tile the reader left on a card is copied from
    there to each of its shards' cards).

    Each shard stages its padded row block on its device, its rows and in
    'cover' mode (the one mode with a neighbourhood operation) ``halo``
    rows of each neighbour, cut at the tile's edges, and makes one
    windowed launch of ``wtr_layers_batched`` (K6 spatial on CUDA, the
    plain chain cropped on the CPU). That staging is the halo exchange of
    ``proteus_tpu/parallel/campaign.py:342-359``; with no ghost rows the
    result is the single-device one. Full outputs only, as in the
    reference.

    Returns ``out[name][k]``, tile k's list of row pieces, one a shard on
    its shard's device, and the totals as Python integers by the
    reference's spatial rule (``campaign.py:441-452``): valid pixels are
    ``~invalid`` (the ocean mask is not applied, unlike the data-parallel
    step), counted over each shard's own rows; ``n_tiles_total`` counts
    tiles.
    """
    if device_scale and not float_inputs:
        raise ValueError('device_scale requires float_inputs=True '
                         '(it feeds the float32 science chain)')
    mesh = [list(row) for row in mesh]
    n_tile, n_space = len(mesh), len(mesh[0])
    reach = halo if config.mask_adjacent_to_cloud_mode == 'cover' else 0
    n_in = 8 + (2 if device_scale else 0) + int(with_ocean) \
        + int(with_shadow) + int(with_landcover)

    def step(*args):
        if len(args) != n_in:
            raise ValueError(f'campaign step: {len(args)} inputs, expected '
                             f'{n_in}')
        b, h, _ = _shape(args[0])
        if b % n_tile:
            raise ValueError(f'batch of {b} does not split over {n_tile} '
                             f'tile rows')
        if h % n_space:
            raise ValueError(f'tile height {h} does not split over '
                             f'{n_space} space shards')
        hl = h // n_space
        if halo > hl:
            raise ValueError(
                f'spatial halo ({halo}) exceeds the per-shard tile height'
                f' ({hl}); use fewer space shards')
        per_row = b // n_tile
        images = list(args[:8]) + list(args[10 if device_scale else 8:])
        out, counts = {}, {}
        for t, row in enumerate(mesh):
            tiles = slice(t * per_row, (t + 1) * per_row)
            for j, dev in enumerate(row):
                r0 = j * hl
                a0, a1 = max(0, r0 - reach), min(h, r0 + hl + reach)
                block = [_tile_rows(a, tiles, slice(a0, a1), dev)
                         for a in images]
                b_, g, r, n, s1, s2, fm, inv, *extras = block
                it = iter(extras)
                kw = dict(ocean=next(it) if with_ocean else None,
                          shadow=next(it) if with_shadow else None,
                          landcover=next(it) if with_landcover else None)
                if device_scale:
                    kw['scales'], kw['offsets'] = (
                        torch.as_tensor(v)[tiles].to(dev).contiguous()
                        for v in args[8:10])
                # the shard's layers and the counts of its own rows, valid
                # pixels without the ocean term (campaign.py:441-452)
                layers = wtr_layers_batched(
                    b_, g, r, n, s1, s2, fm, inv, config,
                    compute_browse=compute_browse, minimal=False,
                    window=(r0 - a0, hl), ocean_in_valid=False, **kw)
                counts.setdefault(dev, []).append(torch.stack(
                    [layers.pop('n_valid').sum(),
                     layers.pop('n_cloud_and_valid').sum()]))
                del layers['n_not_ocean']
                for name, v in layers.items():
                    pieces = out.setdefault(name, [[] for _ in range(b)])
                    for i in range(per_row):
                        pieces[t * per_row + i].append(v[i])
        # one read of a device's totals, which waits for its shards'
        # launches
        sums = [torch.stack(c).sum(0).tolist() for c in counts.values()]
        totals = {
            'n_valid_total': sum(v for v, _ in sums),
            'n_cloud_and_valid_total': sum(c for _, c in sums),
            'n_tiles_total': b,
        }
        return out, totals

    return step


class CampaignManifest:
    """Per-tile status ledger with atomic updates (resume + retry)."""

    def __init__(self, path):
        self.path = path
        self.state = {}
        if path and os.path.isfile(path):
            with open(path) as fh:
                self.state = json.load(fh)

    def status(self, tile_id):
        return self.state.get(tile_id, {}).get('status')

    def mark(self, tile_id, status, **extra):
        entry = self.state.setdefault(tile_id, {})
        entry['status'] = status
        entry['updated'] = time.strftime('%Y-%m-%dT%H:%M:%SZ',
                                         time.gmtime())
        entry.update(extra)
        self._flush()

    def _flush(self):
        if not self.path:
            return
        tmp = self.path + '.tmp'
        with open(tmp, 'w') as fh:
            json.dump(self.state, fh, indent=1)
        os.replace(tmp, self.path)


class _AncillaryCache:
    """Per-grid LRU cache of prepared ancillary products.

    A campaign's ancillary inputs (DEM, CGLS, WorldCover, shoreline) are
    static files, and every HLS revisit of an MGRS tile shares the same
    product grid — so the warped DEM, the LAND mask, and the ocean mask
    are IDENTICAL across the time series; caching them per (file
    signature, grid) turns their cost into a once-per-grid one, whatever
    the number of devices: a value is computed on the device of its first
    reader, and a reader on another device gets a copy (``.to(device)``,
    or the key's ``move``), made once and kept with the value. Terrain
    shadow still runs per tile (it depends on the granule's sun angles)
    but reuses the cached DEM warp.

    Thread-safe with single-flight semantics: concurrent readers of the
    same key (or of its copy on one device) wait for the first
    computation instead of duplicating it. Capacity is keys, not bytes
    (at 3660^2 a grid's DEM with its margin, shadow and LAND are about 85
    MB a device); PROTEUS_TPU_ANC_CACHE=0 disables.
    """

    def __init__(self, max_entries=None):
        self._max = max_entries
        self._lock = threading.Lock()
        self._entries = {}
        self._order = []

    @property
    def max_entries(self):
        if self._max is not None:
            return self._max
        try:
            return int(os.environ.get('PROTEUS_TPU_ANC_CACHE', '4'))
        except ValueError:
            return 4

    def get(self, key, compute, device=None, move=None):
        """The value of ``key``, from ``compute()`` on its first use. With
        ``device``, the value on that device: a value computed on another
        one is copied by ``move(value, device)`` (default: ``.to(device)``
        of each tensor of a tensor or tuple)."""
        if self.max_entries <= 0:
            return compute()
        ent = self._flight(self._entries, key, compute, lru=True)
        value = ent['value']
        if device is None or _device_of(value) == torch.device(device):
            return value
        return self._flight(ent['copies'], str(device), lambda: (
            move or _move)(value, device))['value']

    def _flight(self, table, key, compute, lru=False):
        """The entry of ``key`` in ``table``, computed once: concurrent
        callers wait for the first one's ``compute()``."""
        with self._lock:
            ent = table.get(key)
            owner = ent is None
            if owner:
                ent = {'event': threading.Event(), 'value': None,
                       'error': None, 'copies': {}}
                table[key] = ent
                if lru:
                    self._order.append(key)
                    while len(self._order) > self.max_entries:
                        old = self._order.pop(0)
                        if old != key:
                            self._entries.pop(old, None)
        if not owner:
            ent['event'].wait()
            if ent['error'] is not None:
                raise ent['error']
            return ent
        try:
            ent['value'] = compute()
        except BaseException as e:
            ent['error'] = e
            with self._lock:
                if table.get(key) is ent:
                    del table[key]
                if lru and key in self._order:
                    self._order.remove(key)
            ent['event'].set()
            raise
        ent['event'].set()
        return ent

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._order.clear()


def _device_of(value):
    """The device of a tensor, or of the first tensor of a tuple."""
    if isinstance(value, tuple):
        return _device_of(value[0])
    return value.device


def _move(value, device):
    if isinstance(value, tuple):
        return tuple(_move(v, device) for v in value)
    return value.to(device)


ANCILLARY_CACHE = _AncillaryCache()


# Default tiles per device per batch on CUDA: the value chip_smoke.py's
# phase 5 runs end to end (1.4-2.0 s a 3660^2 tile on an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md). Its phase 5b times the campaign step alone
# at 0.78-0.86 ms a tile at 2 tiles a device and 0.70-0.77 ms at 4: a gap
# no end-to-end run can resolve, while 4 doubles the inputs a batch holds
# on the card and the host. Elsewhere 1.
CUDA_DEFAULT_TILES_PER_DEVICE = 2

def _fsig(path):
    """File identity for cache keys: path + mtime + size."""
    st = os.stat(path)
    return (path, st.st_mtime_ns, st.st_size)


class TileJob:
    """One campaign work item: HLS band files (+ optional ancillaries)
    -> output layer files."""

    def __init__(self, tile_id, input_files, output_dir,
                 product_id='dswx_hls', product_version='0.1',
                 dem_file=None, landcover_file=None, worldcover_file=None,
                 shoreline_shapefile=None,
                 ocean_masking_shoreline_distance_km=1.0):
        self.tile_id = tile_id
        self.input_files = input_files
        self.output_dir = output_dir
        self.product_id = product_id
        self.product_version = product_version
        self.dem_file = dem_file
        self.landcover_file = landcover_file
        self.worldcover_file = worldcover_file
        self.shoreline_shapefile = shoreline_shapefile
        self.ocean_masking_shoreline_distance_km = \
            ocean_masking_shoreline_distance_km


_FAULT_LOCK = threading.Lock()
_FAULT_ATTEMPTS = {}


def _maybe_inject_fault(tile_id):
    """Test-only fault injection (the reference has no fault-injection
    facility; campaigns need one to prove the retry/resume machinery on
    real runs).

    PROTEUS_TPU_FAULT_INJECT="tileA:2,tileB" makes the reader raise an
    IOError for tileA on its first 2 attempts and for tileB on its
    first attempt — a transient failure the retry path must absorb.
    """
    spec = os.environ.get('PROTEUS_TPU_FAULT_INJECT')
    if not spec:
        return
    for item in spec.split(','):
        parts = item.strip().split(':')
        if not parts or parts[0] != tile_id:
            continue
        n = int(parts[1]) if len(parts) > 1 else 1
        with _FAULT_LOCK:
            k = _FAULT_ATTEMPTS.get(tile_id, 0)
            _FAULT_ATTEMPTS[tile_id] = k + 1
        if k < n:
            raise IOError(
                f'injected fault for {tile_id} (attempt {k + 1}/{n})')


_PREP_POOL = None
_PREP_POOL_LOCK = threading.Lock()


def _prep_pool():
    """Shared pool for within-tile ancillary preps (lazy, bounded).

    The three per-tile ancillary groups — ocean rasterization, DEM warp
    + terrain shadow, landcover warps — are independent and each is
    dominated by file reads and device waits, not Python. Running them
    concurrently cuts a COLD tile's critical path from their sum to
    their max (warm tiles hit _AncillaryCache and never enter the
    pool's queue long enough to matter). PROTEUS_TPU_PREP_THREADS sizes
    the pool; 0 disables (serial preps)."""
    global _PREP_POOL
    n = int(os.environ.get('PROTEUS_TPU_PREP_THREADS', '8'))
    if n <= 0:
        return None
    with _PREP_POOL_LOCK:
        if _PREP_POOL is None:
            _PREP_POOL = ThreadPoolExecutor(
                n, thread_name_prefix='anc_prep')
        return _PREP_POOL


def _run_preps(preps):
    """Run prep closures, concurrently when there are 2+ and a pool.

    Each closure returns a dict of image_dict updates (disjoint keys).
    The first prep runs on the calling reader thread — it stays busy
    instead of sleeping on a future — while the rest overlap in the
    pool. Exceptions propagate exactly as the serial code's did (the
    first to fail raises; the campaign retry path handles it)."""
    pool = _prep_pool() if len(preps) > 1 else None
    if pool is None:
        return [fn() for fn in preps]
    futures = [pool.submit(fn) for fn in preps[1:]]
    results = [preps[0]()]
    results += [f.result() for f in futures]
    return results

def _read_tile(job, flag_debug=False, config=None, scaled=False,
               device_scale=False, device=None):
    """Decode one tile's bands + prepare its ancillary masks on ``device``
    (runs in the reader pool, overlapping the device step of the previous
    batch).

    The ancillary groups run concurrently via _run_preps, so a cold grid
    pays max(ocean, dem+shadow, landcover) instead of their sum. The ocean
    mask is the host rasterization dilated on the device, the DEM and
    landcover are device warps, the shadow the exact
    'sun_local_inc_angle' layer; each lives on ``device``.

    ``scaled=True`` applies the per-band scale/offset at ingest
    (float32 reflectance, reference dswx_hls.py:2298-2302).
    ``device_scale=True`` keeps the bands RAW int16 and records the
    per-band scale/offset vectors instead — the step applies the cast on
    the device (half the h2d bytes, no host float pass)."""
    _maybe_inject_fault(job.tile_id)
    from proteus_tpu_torch.io import hls as hls_io
    if device is None:
        device = torch.device('cpu')
    image_dict = {}
    metadata = {}
    offset_dict, scale_dict = {}, {}
    with STAGE_TIMES.stage('read_ingest_decode'):
        ok = hls_io.load_hls_product_v2(job.input_files, image_dict,
                                        offset_dict, scale_dict,
                                        metadata,
                                        scaled and not device_scale,
                                        flag_debug=flag_debug,
                                        device=device)
    if not ok:
        raise IOError(f'could not read tile {job.tile_id}')
    if device_scale:
        image_dict['band_scales'] = np.asarray(
            [scale_dict.get(bn, 1.0) for bn in BANDS], np.float32)
        image_dict['band_offsets'] = np.asarray(
            [offset_dict.get(bn, 0.0) for bn in BANDS], np.float32)
    image_dict['hls_metadata'] = metadata

    gt = image_dict['geotransform']
    proj = image_dict['projection']
    length = image_dict['length']
    width = image_dict['width']

    preps = []

    if job.shoreline_shapefile:
        def _prep_ocean():
            from proteus_tpu_torch.geo.polygon import create_ocean_mask
            with STAGE_TIMES.stage('read_ocean_mask'):
                okey = ('ocean', _fsig(job.shoreline_shapefile),
                        job.ocean_masking_shoreline_distance_km, gt, proj,
                        length, width)
                return {'ocean_mask': ANCILLARY_CACHE.get(
                    okey, lambda: create_ocean_mask(
                        job.shoreline_shapefile,
                        job.ocean_masking_shoreline_distance_km, '.', gt,
                        proj, length, width, device=device), device)}
        preps.append(_prep_ocean)

    if job.dem_file:
        def _prep_dem_shadow():
            from proteus_tpu_torch.geo.warp import warp_to_grid_device
            from proteus_tpu_torch.models.dswx.shadow import (
                compute_opera_shadow_layer_exact,
                compute_otsu_shadow_layer_exact)
            from proteus_tpu_torch.runtime.orchestrator import _mean_angle
            with STAGE_TIMES.stage('read_dem_shadow'):
                az = _mean_angle(
                    metadata.get('MEAN_SUN_AZIMUTH_ANGLE', '0'))
                zen = _mean_angle(
                    metadata.get('MEAN_SUN_ZENITH_ANGLE', '0'))
                min_slope = (config.min_slope_angle
                             if config is not None else -5.0)
                max_inc = (config.max_sun_local_inc_angle
                           if config is not None else 40.0)
                shadow_alg = (config.shadow_masking_algorithm
                              if config is not None and
                              config.shadow_masking_algorithm else
                              'sun_local_inc_angle')
                m = C.DEM_MARGIN_IN_PIXELS
                dkey = ('dem_warp', _fsig(job.dem_file), gt, proj,
                        length, width, m)

                def _crop(dem_m):
                    return dem_m, dem_m[m:-m, m:-m]

                def _warp_dem():
                    return _crop(warp_to_grid_device(
                        job.dem_file, gt, proj, length, width,
                        resample_algorithm='cubic', margin_in_pixels=m,
                        device=device))

                # the DEM warp is per grid (cached); the shadow depends on
                # the granule's sun angles, so its key includes them. Both
                # stay on the device; the writer pool copies them out
                dem_m, dem_crop = ANCILLARY_CACHE.get(
                    dkey, _warp_dem, device,
                    move=lambda v, dev: _crop(v[0].to(dev)))

                def _shadow():
                    if shadow_alg == 'otsu':
                        # reference dswx_hls.py:4430-4436: hillshade over
                        # the margined DEM + global-histogram Otsu cut
                        shad = compute_otsu_shadow_layer_exact(
                            dem_m, az, 90.0 - zen, pixel_spacing_x=gt[1],
                            pixel_spacing_y=gt[5])
                    else:
                        shad = compute_opera_shadow_layer_exact(
                            dem_m, az, 90.0 - zen, min_slope, max_inc)
                    shad_crop = shad[m:-m, m:-m].to(torch.uint8) \
                        .contiguous()
                    # the writer only needs the binary SHAD values: copy
                    # out 1 bit/px
                    return shad_crop, pack_bits_device(shad_crop)

                skey = ('shadow', dkey, az, zen, min_slope, max_inc,
                        shadow_alg)
                shad_crop, shad_packed = ANCILLARY_CACHE.get(
                    skey, _shadow, device)
                # dkey identifies the warped-DEM payload exactly (file
                # signature + grid): the writer reuses the encoded COG
                # blobs across revisits of the grid (io/cog.py
                # PAYLOAD_CACHE — only the metadata tags differ)
                return {'dem': dem_crop, 'dem_payload_key': dkey,
                        'shadow_layer': shad_crop,
                        'shadow_packed': shad_packed}
        preps.append(_prep_dem_shadow)

    if job.landcover_file and job.worldcover_file:
        def _prep_landcover():
            from proteus_tpu_torch.geo.warp import (warp_to_grid_device,
                                                    worldcover_year_of)
            from proteus_tpu_torch.models.dswx.landcover import \
                create_landcover_mask_arrays
            with STAGE_TIMES.stage('read_landcover'):
                forest = tuple(config.forest_mask_landcover_classes
                               if config is not None else
                               (20, 50, 111, 113, 115, 116, 121, 123,
                                125, 126))

                def _landcover():
                    cgls = warp_to_grid_device(
                        job.landcover_file, gt, proj, length, width,
                        resample_algorithm='nearest', device=device)
                    gt3 = (gt[0], gt[1] / 3, 0.0, gt[3], 0.0, gt[5] / 3)
                    wc3 = warp_to_grid_device(
                        job.worldcover_file, gt3, proj, 3 * length,
                        3 * width, resample_algorithm='nearest',
                        device=device)
                    year = worldcover_year_of(job.worldcover_file)
                    return create_landcover_mask_arrays(
                        cgls, wc3, C.LANDCOVER_MASK_TYPE, forest,
                        worldcover_year=year).to(torch.uint8).contiguous()

                lkey = ('landcover', _fsig(job.landcover_file),
                        _fsig(job.worldcover_file), gt, proj, length,
                        width, C.LANDCOVER_MASK_TYPE, forest)
                return {'landcover_mask': ANCILLARY_CACHE.get(
                    lkey, _landcover, device)}
        preps.append(_prep_landcover)

    for updates in _run_preps(preps):
        image_dict.update(updates)
    return image_dict


def _host(a):
    """A device tensor's copy on the host, as numpy; a list of row pieces
    (the spatial step's) is copied piece by piece and joined here."""
    if isinstance(a, (list, tuple)):
        return np.concatenate([_host(p) for p in a], axis=0)
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _write_tile(job, layers, image_dict, metadata, derive_opts=None):
    """Write all available layers (+ browse) for one tile.

    ``layers`` values may still be device tensors, or lists of row pieces
    on their shards' devices — copied out here, in the writer pool, so the
    device->host transfer overlaps the next batch's compute. In
    minimal-transfer mode (a 'PACKED_A' key), the dependent layers are
    derived here too (models/dswx/host_derive.py)."""
    from proteus_tpu_torch.io.png import geotiff2png
    from proteus_tpu_torch.runtime import ctables
    from proteus_tpu_torch.runtime import product_writer as pw
    with STAGE_TIMES.stage('write_d2h_layers'):
        layers = {name: _host(a) for name, a in layers.items()}
    if 'DIAG6' in layers or 'PACKED_A' in layers:
        from proteus_tpu_torch.models.dswx import host_derive
        with STAGE_TIMES.stage('write_unpack_derive'):
            host_derive.derive_dependent_layers(layers,
                                                **(derive_opts or {}))
    geotransform = image_dict['geotransform']
    projection = image_dict['projection']
    os.makedirs(job.output_dir, exist_ok=True)
    saved = []

    def path_for(nn, layer):
        return os.path.join(
            job.output_dir,
            f'{job.product_id}_v{job.product_version}_B{nn:02}'
            f'_{layer}.tif')

    order = [('WTR', 1), ('BWTR', 2), ('CONF', 3), ('DIAG', 4),
             ('WTR-1', 5), ('WTR-2', 6), ('CLOUD', 9)]
    with STAGE_TIMES.stage('write_cog_science'):
        for layer, nn in order:
            path = path_for(nn, layer)
            if layer in ('WTR', 'WTR-1', 'WTR-2'):
                pw.save_dswx_product(layers[layer], layer, path,
                                     metadata, geotransform, projection)
            elif layer == 'CLOUD':
                pw.save_cloud_layer(layers[layer], path, metadata,
                                    geotransform, projection,
                                    description=C.BAND_DESCRIPTION_DICT[
                                        'CLOUD'])
            elif layer == 'BWTR':
                pw.save_binary_water(layers[layer], path, metadata,
                                     geotransform, projection,
                                     description=C.BAND_DESCRIPTION_DICT[
                                         'BWTR'])
            elif layer == 'CONF':
                pw.save_array(layers[layer], path, metadata,
                              geotransform, projection,
                              description=C.BAND_DESCRIPTION_DICT[
                                  'CONF'],
                              ctable=
                              ctables.get_confidence_layer_ctable(),
                              no_data_value=C.UINT8_FILL_VALUE)
            else:
                pw.save_array(layers[layer], path, metadata,
                              geotransform, projection,
                              description=C.BAND_DESCRIPTION_DICT[
                                  'DIAG'],
                              no_data_value=
                              C.DIAGNOSTIC_LAYER_NO_DATA_BINARY_REPR)
            saved.append(path)

    if 'landcover_mask' in image_dict:
        path = path_for(7, 'LAND')
        with STAGE_TIMES.stage('write_cog_land'):
            pw.save_array(_host(image_dict['landcover_mask']), path,
                          metadata,
                          geotransform, projection,
                          description=C.BAND_DESCRIPTION_DICT['LAND'],
                          ctable=ctables.get_landcover_mask_ctable(),
                          no_data_value=C.UINT8_FILL_VALUE)
        saved.append(path)
    if 'shadow_layer' in image_dict:
        path = path_for(8, 'SHAD')
        with STAGE_TIMES.stage('write_cog_shad'):
            if 'shadow_packed' in image_dict:
                from proteus_tpu_torch.models.dswx import host_derive
                shad = host_derive.unpack_bits(
                    _host(image_dict['shadow_packed']), image_dict['width'])
            else:
                shad = _host(image_dict['shadow_layer'])
            pw.save_array(shad, path, metadata,
                          geotransform, projection,
                          description=C.BAND_DESCRIPTION_DICT['SHAD'],
                          ctable=ctables.get_binary_mask_ctable())
        saved.append(path)
    if 'dem' in image_dict:
        path = path_for(10, 'DEM')
        with STAGE_TIMES.stage('write_d2h_dem'):
            dem_host = _host(image_dict['dem'])
        with STAGE_TIMES.stage('write_cog_dem_float32'):
            pw.save_array(dem_host, path, metadata,
                          geotransform, projection,
                          description=C.BAND_DESCRIPTION_DICT['DEM'],
                          no_data_value=float('nan'),
                          payload_key=image_dict.get('dem_payload_key'))
        saved.append(path)

    if 'BROWSE' in layers:
        browse_tif = os.path.join(
            job.output_dir,
            f'{job.product_id}_v{job.product_version}_BROWSE.tif')
        browse_png = browse_tif.replace('.tif', '.png')
        ct = ctables.get_browse_ctable()
        with STAGE_TIMES.stage('write_browse'):
            pw.save_array(layers['BROWSE'], browse_tif, metadata,
                          geotransform, projection, ctable=ct,
                          no_data_value=C.UINT8_FILL_VALUE)
            geotiff2png(browse_tif, browse_png, output_height=1024,
                        output_width=1024, rgba_ctable=ct)
        saved += [browse_tif, browse_png]
    return saved


class CampaignRunner:
    """Drive a tile campaign: prefetch -> device step -> write.

    The reader pool decodes batch k+1 while the devices process batch k;
    the writer pool overlaps COG encoding with both. Tiles that fail I/O
    or validation are retried up to ``max_retries`` and recorded in the
    manifest, so a crashed campaign resumes where it stopped.
    """

    def __init__(self, config: DswxChainConfig = None, mesh=None,
                 manifest_path=None, max_retries=2, reader_threads=None,
                 writer_threads=None, flag_debug=False,
                 save_browse=False, processing_params=None,
                 spatial_shards=1, tiles_per_device=None,
                 scaled_inputs=False, device_scale=None):
        # pool sizing: enough threads to overlap device/link waits with
        # host work, but not so many that they thrash a small host
        ncpu = os.cpu_count() or 1
        if reader_threads is None:
            reader_threads = max(2, min(8, ncpu))
        if writer_threads is None:
            writer_threads = max(2, min(8, ncpu))
        self.config = config or DswxChainConfig()
        self.scaled_inputs = bool(scaled_inputs)
        self.devices = make_tile_mesh(mesh)
        self.spatial_shards = max(1, int(spatial_shards))
        if self.spatial_shards > 1:
            # rows of spatial_shards devices: each tile of a row's share
            # is cut into spatial_shards row shards
            n_dev = len(self.devices)
            if n_dev % self.spatial_shards:
                raise ValueError(
                    f'{n_dev} devices not divisible by spatial_shards='
                    f'{self.spatial_shards}')
            self.mesh = make_tile_space_mesh(
                n_dev // self.spatial_shards, self.spatial_shards,
                self.devices)
        else:
            self.mesh = self.devices
        on_cuda = all(d.type == 'cuda' for d in self.devices)
        if device_scale is None:
            # default on CUDA: the cast runs inside the kernel (K4), which
            # reads half the band bytes; it is bit-identical to the host
            # cast. PROTEUS_TPU_DEVICE_SCALE=0 opts out.
            device_scale = (
                self.scaled_inputs
                and os.environ.get('PROTEUS_TPU_DEVICE_SCALE', '1')
                not in ('0', 'off', 'false')
                and on_cuda)
        self.device_scale = bool(device_scale) and self.scaled_inputs
        if tiles_per_device is None:
            tiles_per_device = (CUDA_DEFAULT_TILES_PER_DEVICE if on_cuda
                                else 1)
        self.tiles_per_device = max(1, int(tiles_per_device))
        self.manifest = CampaignManifest(manifest_path)
        self.max_retries = max_retries
        self.flag_debug = flag_debug
        self.save_browse = save_browse
        self.processing_params = processing_params or {}
        self._steps = {}  # keyed by (ocean, shadow, landcover) presence
        self._readers = ThreadPoolExecutor(reader_threads)
        self._writers = ThreadPoolExecutor(writer_threads)
        # each device's (or, spatially, each mesh row's) share of a batch
        # is one [tiles_per_device, H, W] launch (K6) a device
        self.batch_size = len(self.mesh) * self.tiles_per_device

    def _reader_device(self, i):
        """The device tile i of a batch is read onto: its share's, or
        spatially the first of its mesh row's."""
        share = self.mesh[i // self.tiles_per_device]
        return share[0] if self.spatial_shards > 1 else share

    def _step_for(self, with_ocean, with_shadow, with_landcover):
        key = (with_ocean, with_shadow, with_landcover)
        if key not in self._steps:
            make = make_spatial_campaign_step if self.spatial_shards > 1 \
                else make_campaign_step
            self._steps[key] = make(
                self.config, self.mesh,
                compute_browse=self.save_browse,
                with_ocean=with_ocean, with_shadow=with_shadow,
                with_landcover=with_landcover,
                float_inputs=self.scaled_inputs,
                device_scale=self.device_scale)
        return self._steps[key]

    def _tile_metadata(self, job, image_dict):
        """Per-tile product metadata from the tile's HLS attributes."""
        from proteus_tpu_torch.runtime import metadata as md_util
        md = md_util.get_dswx_metadata_dict(job.product_id,
                                            job.product_version)
        md.update(image_dict.get('hls_metadata', {}))
        md_util.populate_dswx_metadata_datasets(
            md, image_dict.get('hls_dataset_name', job.tile_id),
            dem_file=job.dem_file, landcover_file=job.landcover_file,
            worldcover_file=job.worldcover_file,
            shoreline_shapefile=job.shoreline_shapefile)
        return md

    def _derive_opts(self):
        """Options for the writer-pool derivation of dependent layers
        (minimal-transfer mode); mirrors the chain's BROWSE flags."""
        cfg = self.config
        return {
            'compute_browse': self.save_browse,
            'browse_options': dict(
                flag_collapse_wtr_classes=cfg.flag_collapse_wtr_classes,
                exclude_psw_aggressive=
                    cfg.exclude_psw_aggressive_in_browse,
                set_not_water_to_nodata=
                    cfg.not_water_in_browse == 'nodata',
                set_cloud_to_nodata=cfg.cloud_in_browse == 'nodata',
                set_snow_to_nodata=cfg.snow_in_browse == 'nodata',
                set_ocean_masked_to_nodata=True),
        }

    def run(self, jobs, metadata=None):
        """Process all jobs; returns campaign statistics."""
        pending = [j for j in jobs
                   if self.manifest.status(j.tile_id) != 'done']
        logger.info(f'campaign: {len(jobs)} tiles, {len(pending)} pending,'
                    f' batch={self.batch_size} over'
                    f' {len(self.devices)} devices')
        stats = {'tiles_done': 0, 'tiles_failed': 0,
                 'n_valid_total': 0, 'n_cloud_and_valid_total': 0}
        attempt = {j.tile_id: 0 for j in pending}
        queue = list(pending)
        write_futures = []

        def batches(seq, n):
            for i in range(0, len(seq), n):
                yield seq[i:i + n]

        batch_list = list(batches(queue, self.batch_size))

        def submit(batch):
            # each tile is read onto the device of its share of the batch
            # (_run_batch gives share k tiles k*tpd .. (k+1)*tpd - 1)
            return [(j, self._readers.submit(
                         _read_tile, j, self.flag_debug, self.config,
                         self.scaled_inputs, self.device_scale,
                         self._reader_device(i)))
                    for i, j in enumerate(batch)]

        marked = set()

        def drain_writes(block):
            """Mark finished writes in the manifest NOW (not at campaign
            end) so a killed campaign resumes from every tile whose
            outputs actually landed."""
            for job, fut in write_futures:
                if job.tile_id in marked:
                    continue
                if not block and not fut.done():
                    continue
                marked.add(job.tile_id)
                try:
                    saved = fut.result()
                    self.manifest.mark(job.tile_id, 'done',
                                       outputs=saved)
                    stats['tiles_done'] += 1
                except Exception as e:  # noqa: BLE001
                    logger.error(f'tile {job.tile_id} write failed: {e}')
                    self.manifest.mark(job.tile_id, 'failed',
                                       error=str(e))
                    stats['tiles_failed'] += 1

        # prefetch the first batch; retries may append batches mid-flight
        prefetch = submit(batch_list[0]) if batch_list else None
        bi = 0
        while bi < len(batch_list):
            # prefetch is None when a retry appended a batch after the
            # last scheduled one — submit it now
            current = prefetch if prefetch is not None \
                else submit(batch_list[bi])
            bi += 1
            prefetch = submit(batch_list[bi]) if bi < len(batch_list) \
                else None

            loaded = []
            for job, fut in current:
                try:
                    loaded.append((job, fut.result()))
                except Exception as e:  # noqa: BLE001
                    attempt[job.tile_id] += 1
                    if attempt[job.tile_id] <= self.max_retries:
                        logger.warning(f'tile {job.tile_id} read failed'
                                       f' (attempt {attempt[job.tile_id]}):'
                                       f' {e}; requeueing')
                        batch_list.append([job])
                    else:
                        logger.error(f'tile {job.tile_id} failed: {e}')
                        self.manifest.mark(job.tile_id, 'failed',
                                           error=str(e),
                                           trace=traceback.format_exc())
                        stats['tiles_failed'] += 1
            if not loaded:
                continue

            out, totals = self._run_batch(loaded)
            stats['n_valid_total'] += int(totals['n_valid_total'])
            stats['n_cloud_and_valid_total'] += int(
                totals['n_cloud_and_valid_total'])

            layer_names = [name for name in out
                           if name not in ('n_valid', 'n_cloud_and_valid')]
            for k, (job, image_dict) in enumerate(loaded):
                # hand the writer the device tensors: the copy to the host
                # happens in the writer pool, overlapping the next batch's
                # compute
                layers = {name: out[name][k] for name in layer_names}
                md = self._tile_metadata(job, image_dict)
                md.update(metadata or {})
                write_futures.append(
                    (job, self._writers.submit(
                        _write_tile, job, layers, image_dict, md,
                        self._derive_opts())))
            drain_writes(block=False)

        drain_writes(block=True)
        if STAGE_TIMES.enabled:
            stats['stage_seconds'] = STAGE_TIMES.table()
        return stats


    def _run_batch(self, loaded):
        """Pad the batch to batch_size, stack each device's share on that
        device (spatially, hand the step the tiles: it stages each shard's
        rows), execute."""
        b = self.batch_size
        h = loaded[0][1]['length']
        w = loaded[0][1]['width']
        tpd = self.tiles_per_device
        spatial = self.spatial_shards > 1
        dicts = [d for _, d in loaded]
        dtype_t = {np.int16: torch.int16, np.float32: torch.float32,
                   np.uint8: torch.uint8, bool: torch.bool}

        def stack(key, dtype, pad_value=0):
            """One [tiles_per_device, H, W] tensor a device; tensors the
            reader left on their share's device (ocean, shadow, landcover)
            stack there without a copy. Spatially, one (H, W) array or
            tensor a tile."""
            if spatial:
                tiles = [d[key] if isinstance(d[key], torch.Tensor)
                         else np.asarray(d[key], dtype=dtype)
                         for d in dicts]
                return tiles + [np.full((h, w), pad_value, dtype)] \
                    * (b - len(tiles))
            shares = []
            for k, dev in enumerate(self.mesh):
                arrs = [d[key] for d in dicts[k * tpd:(k + 1) * tpd]]
                tiles = [a.to(dev) if isinstance(a, torch.Tensor)
                         else torch.from_numpy(np.ascontiguousarray(
                             a, dtype=dtype)).to(dev) for a in arrs]
                tiles += [torch.full((h, w), pad_value, dtype=dtype_t[dtype],
                                     device=dev)
                          for _ in range(tpd - len(tiles))]
                shares.append(torch.stack(tiles))
            return shares

        band_dtype = np.float32 \
            if (self.scaled_inputs and not self.device_scale) else np.int16
        with STAGE_TIMES.stage('batch_stage_h2d'):
            args = [stack(key, band_dtype) for key in BANDS]
            args.append(stack('fmask', np.uint8))
            # pad tiles are fully invalid so they contribute nothing to
            # the campaign statistics
            args.append(stack('invalid_ind_array', bool, pad_value=True))
            if self.device_scale:
                # [tiles_per_device, 6] per-band scale/offset vectors; pad
                # tiles get the identity cast (they are fully invalid)
                for key, pad_value in (('band_scales', 1.0),
                                       ('band_offsets', 0.0)):
                    vecs = [np.asarray(d[key], np.float32) for d in dicts]
                    vecs += [np.full(6, pad_value, np.float32)] \
                        * (b - len(vecs))
                    args.append(np.stack(vecs) if spatial else [
                        torch.from_numpy(np.stack(
                            vecs[k * tpd:(k + 1) * tpd])).to(dev)
                        for k, dev in enumerate(self.mesh)])
            d0 = dicts[0]
            with_ocean = 'ocean_mask' in d0
            with_shadow = 'shadow_layer' in d0
            with_landcover = 'landcover_mask' in d0
            if with_ocean:
                args.append(stack('ocean_mask', np.uint8, pad_value=1))
            if with_shadow:
                args.append(stack('shadow_layer', np.uint8, pad_value=1))
            if with_landcover:
                args.append(stack('landcover_mask', np.uint8,
                                  pad_value=255))
        step = self._step_for(with_ocean, with_shadow, with_landcover)
        with STAGE_TIMES.stage('batch_device_step_dispatch'):
            # the totals are Python integers: reading them waits for the
            # step; the layers stay on the devices for the writer pool
            out, totals = step(*args)
        return out, totals
