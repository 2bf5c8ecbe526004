"""The spatially sharded campaign of the port (each tile's rows cut over the
devices of a mesh row) against proteus_tpu's (JAX on its 8 CPU devices),
tolerance 0: the step on a 2 x 4 mesh of CPU devices against JAX's spatial
step through its jnp chain and its Pallas kernel in interpret mode, and
against the port's single-device launch; the windowed plain twin; the
runner and the CLI product file by product file; the ancillary cache
shared across devices.
"""

import glob
import os
import threading

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.models.dswx.chain import DswxChainConfig as JaxConfig
from proteus_tpu.parallel import campaign as jcampaign
from proteus_tpu.parallel.mesh import make_tile_space_mesh as jax_space_mesh
from proteus_tpu_torch.cli import dswx_campaign as tcli
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.ops import wtr_kernel
from proteus_tpu_torch.parallel import campaign as tcampaign
from proteus_tpu_torch.parallel.mesh import (make_tile_mesh,
                                             make_tile_space_mesh)
from test_torch_batched import KINDS, T, batch_inputs

torch.set_num_threads(1)

CPU8 = [torch.device('cpu')] * 8
B, H, W = 2, 128, 64  # 4 shards of 32 rows: seams at rows 32, 64, 96
EXTRAS = ('ocean', 'shadow', 'landcover')


def seam_fmask(seed, b, h, w):
    """An Fmask for 'cover' across the seams of 4 row shards:
    adjacent-to-cloud (bit 2) nearly everywhere, column stripes of snow
    (bit 4) through every seam, snow rows and clear gaps within 17 rows
    of each seam, cloud and shadow blocks, and random bytes in 10% of the
    pixels; shifted from tile to tile."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for k in range(b):
        y, x = yy + 7 * k, xx + 5 * k
        f = np.where((x // 9 + y // 11) % 5 != 0, 4, 0)
        f |= np.where(x % 23 < 2, 16, 0)                    # column stripes
        for seam in range(h // 4, h, h // 4):
            f[seam - 6:seam - 4, 5 * k:w // 2] |= 16        # above a seam
            f[seam + 9, w // 3:] |= 16                      # below it
        f |= np.where((y % 40 >= 20) & (y % 40 < 24)
                      & (x % 30 >= 10) & (x % 30 < 14), 2, 0)  # cloud
        f |= np.where((y % 50 >= 40) & (y % 50 < 43)
                      & (x % 20 < 3), 8, 0)                 # shadow
        noise = rng.random((h, w)) < 0.1
        out.append(np.where(noise, rng.integers(0, 256, (h, w)), f))
    return np.stack(out).astype(np.uint8)


def spatial_inputs(seed, kind):
    x = batch_inputs(seed, kind, B, H, W)
    x['fmask'] = seam_fmask(seed, B, H, W)
    return x


def step_args(x, kind, extras):
    args = [*x['bands'], x['fmask'], x['invalid']]
    if kind == 'device_scale':
        args += [x['scales'], x['offsets']]
    return args + [x[k] for k in extras]


def step_kw(kind, extras, browse):
    return dict(compute_browse=browse, float_inputs=kind != 'int16',
                device_scale=kind == 'device_scale',
                **{f'with_{k}': k in extras for k in EXTRAS})


def tile(out, name, k):
    """Tile k of a layer of the spatial step: its row pieces joined."""
    return np.concatenate([p.numpy() for p in out[name][k]])


def run_port(cfg, x, kind, extras, browse, halo=tcampaign.SPATIAL_HALO):
    step = tcampaign.make_spatial_campaign_step(
        cfg, make_tile_space_mesh(2, 4, CPU8), halo=halo,
        **step_kw(kind, extras, browse))
    return step(*step_args(x, kind, extras))


def single_device(cfg, x, kind, extras, browse):
    """The port's one launch over the whole [B, H, W] stack."""
    scaled = kind == 'device_scale'
    return wtr_kernel.wtr_layers_batched(
        *[T(a) for a in x['bands']], T(x['fmask']), T(x['invalid']), cfg,
        scales=T(x['scales']) if scaled else None,
        offsets=T(x['offsets']) if scaled else None,
        **{k: T(x[k]) for k in extras}, compute_browse=browse)


def spatial_totals(x, mode):
    """The reference's spatial totals: valid = ~invalid, no ocean."""
    from proteus_tpu_torch.models.dswx.masking import \
        compute_preliminary_cloud_layer
    valid = ~x['invalid']
    prelim = compute_preliminary_cloud_layer(T(x['fmask']), mode).numpy()
    return {'n_valid_total': int(valid.sum()),
            'n_cloud_and_valid_total': int(((prelim != 0) & valid).sum()),
            'n_tiles_total': B}


# ---- the step against JAX's and the single-device launch -------------------

CASES = [(mode, kind, extras)
         for mode in wtr_kernel.MODES for kind in KINDS
         for extras in ((), EXTRAS)]


@pytest.mark.parametrize('mode,kind,extras', CASES)
def test_spatial_step_matches_jax_and_single_device(mode, kind, extras):
    """The port's step on 2 x 4 CPU devices == JAX's spatial step (jnp
    chain) on its 2 x 4 mesh == the port's single-device launch, every
    layer of every tile, and the totals by the spatial rule."""
    x = spatial_inputs(40 + CASES.index((mode, kind, extras)), kind)
    browse = bool(extras)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
    out, totals = run_port(cfg, x, kind, extras, browse)
    jstep = jcampaign.make_spatial_campaign_step(
        JaxConfig(mask_adjacent_to_cloud_mode=mode), jax_space_mesh(2, 4),
        use_pallas=False, **step_kw(kind, extras, browse))
    jout, jtotals = jstep(*step_args(x, kind, extras))
    single = single_device(cfg, x, kind, extras, browse)
    layers = wtr_kernel.LAYERS + (('BROWSE',) if browse else ())
    assert sorted(out) == sorted(layers)
    for name in layers:
        for k in range(B):
            pieces = out[name][k]
            assert [tuple(p.shape) for p in pieces] == [(H // 4, W)] * 4
            got = tile(out, name, k)
            np.testing.assert_array_equal(got, np.asarray(jout[name][k]),
                                          err_msg=f'tile {k} {name} (jax)')
            np.testing.assert_array_equal(got, single[name][k].numpy(),
                                          err_msg=f'tile {k} {name}')
    assert totals == {k: int(v) for k, v in jtotals.items()}
    assert totals == spatial_totals(x, mode)


@pytest.mark.parametrize('mode,kind', [('cover', 'device_scale'),
                                       ('ignore', 'int16'),
                                       ('mask', 'float32')])
def test_spatial_step_matches_jax_pallas(mode, kind):
    """Against JAX's spatial step through the Pallas kernel (interpret
    mode, 8-row blocks), with every ancillary plane and browse."""
    x = spatial_inputs(60 + KINDS.index(kind), kind)
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
    out, totals = run_port(cfg, x, kind, EXTRAS, True)
    jstep = jcampaign.make_spatial_campaign_step(
        JaxConfig(mask_adjacent_to_cloud_mode=mode), jax_space_mesh(2, 4),
        use_pallas=True, pallas_interpret=True, pallas_block_rows=8,
        **step_kw(kind, EXTRAS, True))
    jout, jtotals = jstep(*step_args(x, kind, EXTRAS))
    for name in wtr_kernel.LAYERS + ('BROWSE',):
        for k in range(B):
            np.testing.assert_array_equal(tile(out, name, k),
                                          np.asarray(jout[name][k]),
                                          err_msg=f'tile {k} {name}')
    assert totals == {k: int(v) for k, v in jtotals.items()}


def test_seams_need_the_halo():
    """The seam Fmask makes 'cover' reach across the seams: without a halo
    the shards' CLOUD differs from the single-device launch near them;
    with 17 rows it does not."""
    x = spatial_inputs(70, 'int16')
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode='cover')
    want = single_device(cfg, x, 'int16', (), False)['CLOUD'].numpy()
    cut, _ = run_port(cfg, x, 'int16', (), False, halo=0)
    rows = set()
    for k in range(B):
        rows |= set(np.nonzero((tile(cut, 'CLOUD', k) != want[k])
                               .any(axis=1))[0].tolist())
    seams = range(H // 4, H, H // 4)
    near = {r for r in rows if min(abs(r - s) for s in seams) <= 17}
    assert near == rows and {min(seams, key=lambda s: abs(r - s))
                             for r in rows} == set(seams)
    out, _ = run_port(cfg, x, 'int16', (), False)
    for k in range(B):
        np.testing.assert_array_equal(tile(out, 'CLOUD', k), want[k])


def test_spatial_totals_ignore_the_ocean():
    """The reference's spatial step counts valid pixels without the ocean
    mask (campaign.py:441-452), the data-parallel step with it: on a tile
    with a shoreline the two disagree, and the port reproduces both."""
    x = spatial_inputs(71, 'int16')
    x['ocean'] = np.ones((B, H, W), np.uint8)
    x['ocean'][:, :, W // 2:] = 0  # the east half is ocean
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode='cover')
    _, totals = run_port(cfg, x, 'int16', ('ocean',), False)
    jstep = jcampaign.make_spatial_campaign_step(
        JaxConfig(mask_adjacent_to_cloud_mode='cover'), jax_space_mesh(2, 4),
        use_pallas=False, with_ocean=True)
    _, jtotals = jstep(*step_args(x, 'int16', ('ocean',)))
    assert totals == {k: int(v) for k, v in jtotals.items()}
    assert totals == spatial_totals(x, 'cover')
    _, dp = tcampaign.make_campaign_step(
        cfg, make_tile_mesh(CPU8[:2]), with_ocean=True)(
            *step_args(x, 'int16', ('ocean',)))
    assert dp['n_valid_total'] == int((~x['invalid'][:, :, :W // 2]).sum())
    assert dp['n_valid_total'] < totals['n_valid_total']


@pytest.mark.parametrize('mode', ['mask', 'cover'])
def test_windowed_plain_twin(mode):
    """wtr_layers_batched with a window on CPU tensors (its plain twin):
    the plain chain of a shard's padded block, cropped to the window, ==
    the plain chain of the whole tile, rows cut, and its coverage counts
    those of the window's rows; at an inner shard and at the tile's two
    edges."""
    x = spatial_inputs(72, 'int16')
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
    whole = wtr_kernel.wtr_layers_batched(
        *[T(a) for a in x['bands']], T(x['fmask']), T(x['invalid']), cfg)
    for r0, r1 in ((32, 64), (0, 32), (96, 128)):
        a0, a1 = max(0, r0 - 17), min(H, r1 + 17)
        got = wtr_kernel.wtr_layers_batched(
            *[T(a[:, a0:a1]) for a in x['bands']], T(x['fmask'][:, a0:a1]),
            T(x['invalid'][:, a0:a1]), cfg, window=(r0 - a0, r1 - r0))
        assert sorted(got) == sorted(whole)
        for name in wtr_kernel.LAYERS + ('BROWSE',):
            np.testing.assert_array_equal(
                got[name].numpy(), whole[name][:, r0:r1].numpy(),
                err_msg=f'rows {r0}..{r1} {name}')
        valid = ~x['invalid'][:, r0:r1]
        cloudy = (x['fmask'][:, r0:r1] & (10 | 4 * (mode == 'mask'))) != 0
        for name, want in (('n_valid', valid),
                           ('n_cloud_and_valid', valid & cloudy),
                           ('n_not_ocean', np.ones_like(valid))):
            np.testing.assert_array_equal(got[name].numpy(),
                                          want.sum((1, 2)),
                                          err_msg=f'rows {r0}..{r1} {name}')
    with pytest.raises(ValueError, match='window'):
        wtr_kernel.wtr_layers_batched(
            *[T(a) for a in x['bands']], T(x['fmask']), T(x['invalid']),
            cfg, window=(100, 30))


def test_spatial_step_errors():
    cfg = DswxChainConfig(mask_adjacent_to_cloud_mode='cover')
    mesh = make_tile_space_mesh(2, 4, CPU8)
    x = spatial_inputs(73, 'int16')
    with pytest.raises(ValueError, match=r'halo \(40\) exceeds'):
        tcampaign.make_spatial_campaign_step(cfg, mesh, halo=40)(
            *step_args(x, 'int16', ()))
    cut = {k: (v[:, :126] if isinstance(v, np.ndarray) and v.ndim == 3
               else v) for k, v in x.items()}
    cut['bands'] = [b[:, :126] for b in x['bands']]
    with pytest.raises(ValueError, match='does not split over 4 space'):
        tcampaign.make_spatial_campaign_step(cfg, mesh)(
            *step_args(cut, 'int16', ()))
    with pytest.raises(ValueError, match='float_inputs'):
        tcampaign.make_spatial_campaign_step(cfg, mesh, device_scale=True)
    with pytest.raises(ValueError, match='inputs, expected'):
        tcampaign.make_spatial_campaign_step(cfg, mesh, with_ocean=True)(
            *step_args(x, 'int16', ()))


def test_make_tile_space_mesh(monkeypatch):
    mesh = make_tile_space_mesh(2, 4, CPU8)
    assert mesh == [CPU8[:4], CPU8[4:]]
    cards = [torch.device('cuda', 0)] * 4  # repeats: one card, 4 shards
    assert make_tile_space_mesh(1, 4, cards) == [cards]
    with pytest.raises(ValueError, match='needs 6 devices, have 8'):
        make_tile_space_mesh(2, 3, CPU8)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        make_tile_space_mesh(1, 1)


# ---- the ancillary cache across devices ------------------------------------

class _Placed:
    """A stand-in for a device tensor: its device and the copies made."""

    def __init__(self, device, log):
        self.device, self.log = torch.device(device), log

    def to(self, device):
        self.log.append(str(device))
        threading.Event().wait(0.02)
        return _Placed(device, self.log)


def test_ancillary_cache_copies_across_devices():
    """One computation a key whatever the device; a reader on another
    device gets one copy, made once however many threads ask at once,
    and kept."""
    cache = tcampaign._AncillaryCache(max_entries=4)
    computed, copies = [], []

    def compute():
        computed.append(1)
        return _Placed('cpu', copies), _Placed('cpu', copies)
    first = cache.get('k', compute, torch.device('cpu'))
    barrier = threading.Barrier(4, timeout=10)
    got = []

    def worker():
        barrier.wait()
        got.append(cache.get('k', compute, 'cuda:1'))
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(computed) == 1 and copies == ['cuda:1', 'cuda:1']
    assert all(g is got[0] for g in got) and got[0] is not first
    assert all(v.device == torch.device('cuda', 1) for v in got[0])
    assert cache.get('k', compute, torch.device('cpu')) is first
    assert cache.get('k', compute, 'cuda:1') is got[0]
    assert len(computed) == 1 and len(copies) == 2


def test_read_tile_warps_a_grid_once_across_devices(tmp_path, monkeypatch):
    """Two devices read tiles of one grid: the DEM, CGLS and WorldCover
    are warped once, the second device gets the same arrays."""
    import proteus_tpu_torch.geo.warp as warp_mod
    root = str(tmp_path)
    d = os.path.join(root, 'in')
    synthetic.make_hls_v2_dataset(d, size=64, seed=5)
    job = tcampaign.TileJob(
        't', sorted(glob.glob(os.path.join(d, '*.tif'))), root,
        dem_file=synthetic.make_dem(root, size=64),
        landcover_file=synthetic.make_landcover(root, size=64),
        worldcover_file=synthetic.make_worldcover(root, size=64),
        shoreline_shapefile=synthetic.make_shoreline(root, size=64),
        ocean_masking_shoreline_distance_km=0.3)
    calls = []
    warp = warp_mod.warp_to_grid_device

    def counting(*a, **kw):
        calls.append(kw['device'])
        return warp(*a, **kw)
    monkeypatch.setattr(warp_mod, 'warp_to_grid_device', counting)
    tcampaign.ANCILLARY_CACHE.clear()
    cfg = DswxChainConfig()
    d0 = tcampaign._read_tile(job, config=cfg, device=torch.device('cpu'))
    d1 = tcampaign._read_tile(job, config=cfg,
                              device=torch.device('cpu', 0))
    assert len(calls) == 3 and set(calls) == {torch.device('cpu')}
    for key in ('dem', 'shadow_layer', 'shadow_packed', 'landcover_mask',
                'ocean_mask'):
        np.testing.assert_array_equal(d1[key].numpy(), d0[key].numpy(),
                                      err_msg=key)
    ent = tcampaign.ANCILLARY_CACHE._entries[d0['dem_payload_key']]
    assert list(ent['copies']) == ['cpu:0']
    tcampaign.ANCILLARY_CACHE.clear()


# ---- the runner and the CLI ------------------------------------------------

SIZE = 96
# the products' processing time, fixed so that two runs write the same bytes
FIXED = {'PROCESSING_DATETIME': '2026-01-01T00:00:00Z'}


@pytest.fixture(scope='module')
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp('spatial_tiles')
    dirs = []
    for t in range(3):
        d = str(root / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=SIZE, seed=700 + t)
        dirs.append(d)
    anc = dict(dem_file=synthetic.make_dem(str(root), size=SIZE),
               landcover_file=synthetic.make_landcover(str(root), size=SIZE),
               worldcover_file=synthetic.make_worldcover(str(root),
                                                         size=SIZE),
               shoreline_shapefile=synthetic.make_shoreline(str(root),
                                                            size=SIZE),
               ocean_masking_shoreline_distance_km=0.3)
    return dirs, anc


def _jobs(module, dirs, anc, out):
    return [module.TileJob(f'tile_{t}',
                           sorted(glob.glob(os.path.join(d, '*.tif'))),
                           os.path.join(out, f'tile_{t}'),
                           product_id=f'tile_{t}', **anc)
            for t, d in enumerate(dirs)]


def _same_files(want_dir, got_dir, n_files, same_bytes=True):
    """Every product file of ``want_dir`` byte-identical in ``got_dir``
    (or, without ``same_bytes``, the same arrays)."""
    want = sorted(glob.glob(os.path.join(want_dir, '*', '*.tif'))
                  + glob.glob(os.path.join(want_dir, '*', '*.png')))
    assert len(want) == n_files, len(want)
    for wf in want:
        gf = os.path.join(got_dir, os.path.relpath(wf, want_dir))
        if same_bytes:
            with open(wf, 'rb') as a, open(gf, 'rb') as b:
                assert a.read() == b.read(), gf
        elif wf.endswith('.tif'):
            with TiffReader(wf) as ra, TiffReader(gf) as rb:
                np.testing.assert_array_equal(rb.read(), ra.read(),
                                              err_msg=gf)


@pytest.mark.parametrize('case', ['cover', 'scaled'])
def test_spatial_runner_matches_data_parallel_and_jax(tiles, tmp_path,
                                                      case):
    """CampaignRunner(spatial_shards=4) on 8 CPU devices (2 tile rows of 4
    shards) over 3 jobs: every product file byte-identical to the port's
    data-parallel run and to JAX's spatial runner. 'cover' with a
    shoreline, DEM, CGLS, WorldCover and browse; 'scaled' with the
    device-side cast."""
    dirs, anc = tiles
    mode = 'cover' if case == 'cover' else 'mask'
    if case == 'scaled':
        anc = {}
    kw = dict(save_browse=case == 'cover', scaled_inputs=case == 'scaled',
              device_scale=case == 'scaled')
    jcampaign.ANCILLARY_CACHE.clear()
    jout = str(tmp_path / 'jax')
    jrunner = jcampaign.CampaignRunner(
        config=JaxConfig(mask_adjacent_to_cloud_mode=mode),
        spatial_shards=4, **kw)
    assert jrunner.run(_jobs(jcampaign, dirs, anc, jout),
                       metadata=FIXED)['tiles_done'] == 3
    outs = {}
    for shards in (1, 4):
        tcampaign.ANCILLARY_CACHE.clear()
        outs[shards] = str(tmp_path / f'torch_{shards}')
        runner = tcampaign.CampaignRunner(
            config=DswxChainConfig(mask_adjacent_to_cloud_mode=mode),
            mesh=CPU8, spatial_shards=shards, **kw)
        assert runner.batch_size == 8 // shards
        stats = runner.run(_jobs(tcampaign, dirs, anc, outs[shards]),
                           metadata=FIXED)
        assert stats['tiles_done'] == 3 and stats['tiles_failed'] == 0
    tcampaign.ANCILLARY_CACHE.clear()
    n_files = 3 * (12 if case == 'cover' else 7)
    _same_files(outs[1], outs[4], n_files)
    _same_files(jout, outs[4], n_files)


def test_spatial_runner_reads_tiles_onto_their_rows(tiles, monkeypatch):
    """Each tile is read onto the first device of its mesh row, and the
    runner refuses a device count that does not divide."""
    mesh = [torch.device('cpu', k) for k in range(4)]
    runner = tcampaign.CampaignRunner(mesh=mesh, spatial_shards=2,
                                      tiles_per_device=2)
    assert runner.mesh == [mesh[:2], mesh[2:]] and runner.batch_size == 4
    assert [runner._reader_device(i) for i in range(4)] == \
        [mesh[0], mesh[0], mesh[2], mesh[2]]
    with pytest.raises(ValueError, match='not divisible by spatial_shards'):
        tcampaign.CampaignRunner(mesh=mesh[:3], spatial_shards=2)


def test_cli_spatial_shards(tiles, tmp_path, monkeypatch):
    """dswx_campaign --spatial-shards 2 over two CPU devices: the same
    layers as the data-parallel CLI run."""
    dirs, anc = tiles
    monkeypatch.setattr(tcli, '_devices',
                        lambda: make_tile_mesh([torch.device('cpu')] * 2))
    argv = dirs[:2] + ['--mask-adjacent-to-cloud-mode', 'cover', '-s',
                       anc['shoreline_shapefile'],
                       '--ocean-masking-distance-km', '0.3']
    for shards in ('1', '2'):
        tcampaign.ANCILLARY_CACHE.clear()
        tcli.main(argv + ['-o', str(tmp_path / shards), '--spatial-shards',
                          shards])
    tcampaign.ANCILLARY_CACHE.clear()
    _same_files(str(tmp_path / '1'), str(tmp_path / '2'), 2 * 7,
                same_bytes=False)
