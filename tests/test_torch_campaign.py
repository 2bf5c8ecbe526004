"""The campaign of the port against proteus_tpu's (JAX on the CPU),
tolerance 0: the campaign step on 8 CPU devices against JAX's on its 8 CPU
devices, the host derivation of the packed layers, and CampaignRunner and
the campaign CLI product file by product file.
"""

import functools
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.models.dswx import host_derive as jderive
from proteus_tpu.models.dswx.chain import DswxChainConfig as JaxConfig
from proteus_tpu.parallel import campaign as jcampaign
from proteus_tpu.parallel.mesh import make_tile_mesh as jax_mesh
from proteus_tpu_torch.cli import dswx_campaign as tcli
from proteus_tpu_torch.models.dswx import host_derive as tderive
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.ops import wtr_kernel
from proteus_tpu_torch.parallel import campaign as tcampaign
from proteus_tpu_torch.parallel.mesh import make_tile_mesh
from proteus_tpu_torch.runtime.compare import compare_dswx_hls_products
from test_torch_batched import KINDS, T, batch_inputs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device('cpu')] * 8


# ---- the campaign step over 8 CPU devices ---------------------------------

def _step_inputs(x, scaled, ancillaries):
    args = [*x['bands'], x['fmask'], x['invalid']]
    if scaled:
        args += [x['scales'], x['offsets']]
    if ancillaries:
        args += [x['ocean'], x['shadow'], x['landcover']]
    return args


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('mode', ['mask', 'cover'])
def test_campaign_step_packed_matches_jax(mode, kind):
    """The port's step with minimal outputs on 8 CPU devices == JAX's
    Pallas step (interpret mode) on its 8 CPU devices: the same PACKED
    planes tile by tile and the same totals."""
    b, h, w = 8, 24, 32
    x = batch_inputs(21, kind, b, h, w)
    scaled = kind == 'device_scale'
    kw = dict(with_ocean=True, with_shadow=True, with_landcover=True,
              float_inputs=kind != 'int16', device_scale=scaled)
    step = tcampaign.make_campaign_step(
        DswxChainConfig(mask_adjacent_to_cloud_mode=mode),
        make_tile_mesh(CPU8), minimal=True, **kw)
    jstep = jcampaign.make_campaign_step(
        JaxConfig(mask_adjacent_to_cloud_mode=mode), jax_mesh(),
        use_pallas=True, pallas_interpret=True, pallas_block_rows=8, **kw)
    args = _step_inputs(x, scaled, True)
    out, totals = step(*args)
    jout, jtotals = jstep(*args)
    # JAX's n_not_ocean is left out of the port's step: no total reads it
    assert 'n_not_ocean' not in out
    for name in ('PACKED_A', 'PACKED_B', 'n_valid', 'n_cloud_and_valid'):
        for k in range(b):
            np.testing.assert_array_equal(out[name][k].numpy(),
                                          np.asarray(jout[name][k]),
                                          err_msg=f'tile {k} {name}')
    assert totals == {k: int(v) for k, v in jtotals.items()}


@pytest.mark.parametrize('browse', [False, True])
def test_campaign_step_full_matches_jax_chain(browse):
    """minimal=False: the port's full layers == JAX's chain path
    (use_pallas=False), with 2 tiles a device."""
    b, h, w = 16, 16, 24
    x = batch_inputs(22, 'int16', b, h, w)
    cfg = dict(mask_adjacent_to_cloud_mode='cover')
    step = tcampaign.make_campaign_step(
        DswxChainConfig(**cfg), make_tile_mesh(CPU8), compute_browse=browse,
        with_shadow=True, minimal=False)
    jstep = jcampaign.make_campaign_step(
        JaxConfig(**cfg), jax_mesh(), compute_browse=browse,
        with_shadow=True, use_pallas=False)
    args = [*x['bands'], x['fmask'], x['invalid'], x['shadow']]
    out, totals = step(*args)
    jout, jtotals = jstep(*args)
    layers = wtr_kernel.LAYERS + (('BROWSE',) if browse else ())
    assert set(layers) <= set(out)
    for name in layers + ('n_valid', 'n_cloud_and_valid'):
        for k in range(b):
            np.testing.assert_array_equal(out[name][k].numpy(),
                                          np.asarray(jout[name][k]),
                                          err_msg=f'tile {k} {name}')
    assert totals == {k: int(v) for k, v in jtotals.items()}


def test_campaign_step_defaults_and_errors():
    cfg = DswxChainConfig()
    with pytest.raises(ValueError, match='float_inputs'):
        tcampaign.make_campaign_step(cfg, CPU8, device_scale=True)
    x = batch_inputs(23, 'int16', 6, 8, 8)
    step = tcampaign.make_campaign_step(cfg, make_tile_mesh(CPU8[:3]))
    out, totals = step(*x['bands'], x['fmask'], x['invalid'])
    assert 'DIAG' in out and 'PACKED_A' not in out  # CPU: full outputs
    assert len(out['DIAG']) == 6 and totals['n_tiles_total'] == 6
    with pytest.raises(ValueError, match='split'):
        tcampaign.make_campaign_step(cfg, make_tile_mesh(CPU8[:4]))(
            *x['bands'], x['fmask'], x['invalid'])


def test_make_tile_mesh(monkeypatch):
    assert make_tile_mesh(CPU8) == CPU8
    with pytest.raises(ValueError):
        make_tile_mesh([])
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        make_tile_mesh()


def test_pack_bits_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.random((13, 37)) < 0.5).astype(np.uint8)
    got = tcampaign.pack_bits_device(T(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jcampaign.pack_bits_device(x)))
    np.testing.assert_array_equal(tderive.unpack_bits(got, 37), x)


# ---- host derivation -------------------------------------------------------

@pytest.mark.parametrize('native', [True, False])
@pytest.mark.parametrize('browse', [False, True])
def test_host_derive_matches_jax(monkeypatch, native, browse):
    """derive_dependent_layers on packed planes, the port's against JAX's,
    on the native codec's fused pass and on the NumPy maps."""
    rng = np.random.default_rng(31)
    shape = (40, 56)
    diag6 = rng.integers(0, 33, shape).astype(np.uint8)
    cloud = rng.choice(np.array([0, 1, 2, 4, 5, 8, 10, 13, 15], np.uint8),
                       shape)
    idx = rng.integers(0, 7, (2,) + shape)
    pa = diag6 | ((cloud & 3) << 6)
    pb = ((cloud >> 2) & 3) | (idx[0] << 2) | (idx[1] << 5)
    opts = dict(compute_browse=browse, browse_options=dict(
        flag_collapse_wtr_classes=True, exclude_psw_aggressive=True,
        set_not_water_to_nodata=browse, set_cloud_to_nodata=False,
        set_snow_to_nodata=False, set_ocean_masked_to_nodata=True))
    from proteus_tpu import native as jnative
    from proteus_tpu_torch import native as tnative
    if not native:
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, 'has_unpack_derive', lambda: False)
    got = tderive.derive_dependent_layers(
        {'PACKED_A': pa.astype(np.uint8), 'PACKED_B': pb.astype(np.uint8)},
        **opts)
    want = jderive.derive_dependent_layers(
        {'PACKED_A': pa.astype(np.uint8), 'PACKED_B': pb.astype(np.uint8)},
        **opts)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# ---- CampaignRunner, port against JAX --------------------------------------

SIZE = 96
N_JOBS = 10


@pytest.fixture(scope='module')
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp('campaign_tiles')
    dirs = []
    for t in range(N_JOBS):
        d = str(root / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=SIZE, seed=800 + t)
        dirs.append(d)
    anc = dict(dem_file=synthetic.make_dem(str(root), size=SIZE),
               landcover_file=synthetic.make_landcover(str(root), size=SIZE),
               worldcover_file=synthetic.make_worldcover(str(root),
                                                         size=SIZE),
               shoreline_shapefile=synthetic.make_shoreline(str(root),
                                                            size=SIZE),
               ocean_masking_shoreline_distance_km=0.3)
    return root, dirs, anc


def _jobs(module, dirs, anc, out):
    return [module.TileJob(f'tile_{t}',
                           sorted(glob.glob(os.path.join(d, '*.tif'))),
                           os.path.join(out, f'tile_{t}'),
                           product_id=f'tile_{t}', **anc)
            for t, d in enumerate(dirs)]


def _assert_same_products(want_dir, got_dir):
    want = sorted(glob.glob(os.path.join(want_dir, '*', '*.tif')))
    assert len(want) == N_JOBS * 11, len(want)
    for wf in want:
        gf = os.path.join(got_dir, os.path.relpath(wf, want_dir))
        with TiffReader(wf) as rw, TiffReader(gf) as rg:
            np.testing.assert_array_equal(rg.read(), rw.read(), err_msg=gf)
        assert compare_dswx_hls_products(wf, gf), gf
    for wf in glob.glob(os.path.join(want_dir, '*', '*.png')):
        gf = os.path.join(got_dir, os.path.relpath(wf, want_dir))
        with open(wf, 'rb') as a, open(gf, 'rb') as b:
            assert a.read() == b.read(), gf


@pytest.mark.parametrize('case', ['mask', 'cover', 'scaled', 'packed'])
def test_runner_matches_jax(tiles, tmp_path, monkeypatch, case):
    """Both runners over the same 10 jobs with DEM, CGLS, WorldCover and a
    shoreline, browse on: every product file array-equal and accepted by
    compare_dswx_hls_products. 'packed' runs the port's step with the
    minimal outputs (K5's packing, the host derivation) on the CPU."""
    _, dirs, anc = tiles
    mode = 'cover' if case == 'cover' else 'mask'
    scaled = case == 'scaled'
    kw = dict(save_browse=True, scaled_inputs=scaled)
    jcampaign.ANCILLARY_CACHE.clear()
    jout = str(tmp_path / 'jax')
    jrunner = jcampaign.CampaignRunner(
        config=JaxConfig(mask_adjacent_to_cloud_mode=mode),
        manifest_path=os.path.join(jout, 'm.json'), **kw)
    assert jrunner.run(_jobs(jcampaign, dirs, anc, jout))['tiles_done'] \
        == N_JOBS
    if case == 'packed':
        monkeypatch.setattr(tcampaign, 'make_campaign_step',
                            functools.partial(tcampaign.make_campaign_step,
                                              minimal=True))
    tcampaign.ANCILLARY_CACHE.clear()
    tout = str(tmp_path / 'torch')
    runner = tcampaign.CampaignRunner(
        config=DswxChainConfig(mask_adjacent_to_cloud_mode=mode),
        mesh=CPU8, manifest_path=os.path.join(tout, 'm.json'), **kw)
    assert runner.batch_size == 8 and runner.device_scale is False
    stats = runner.run(_jobs(tcampaign, dirs, anc, tout))
    assert stats['tiles_done'] == N_JOBS and stats['tiles_failed'] == 0
    _assert_same_products(jout, tout)


def test_runner_resume_retry_and_padding(tiles, tmp_path, monkeypatch):
    """Manifest resume, a transient read fault retried, and
    tiles_per_device > 1 with a padded last batch, products equal to the
    one-tile-a-device run."""
    _, dirs, _ = tiles
    dirs = dirs[:5]

    def run(out, **kw):
        runner = tcampaign.CampaignRunner(
            mesh=CPU8[:2], manifest_path=os.path.join(out, 'm.json'), **kw)
        jobs = [tcampaign.TileJob(f'tile_{t}',
                                  sorted(glob.glob(os.path.join(d, '*.tif'))),
                                  os.path.join(out, f'tile_{t}'),
                                  product_id=f'tile_{t}')
                for t, d in enumerate(dirs)]
        return runner, runner.run(jobs)

    one = str(tmp_path / 'one')
    runner, stats = run(one, tiles_per_device=1)
    assert stats['tiles_done'] == 5
    # resume: every tile is done, nothing runs again (and nothing is
    # counted: no copy, no cache lookup)
    _, stats = run(one, tiles_per_device=1)
    assert stats == {'tiles_done': 0, 'tiles_failed': 0,
                     'n_valid_total': 0, 'n_cloud_and_valid_total': 0,
                     'counters': {}}
    # a batch of 2 devices x 2 tiles: 5 jobs pad the last batch; tile_1
    # fails its first read and is retried
    monkeypatch.setattr(tcampaign, '_FAULT_ATTEMPTS', {})
    monkeypatch.setenv('PROTEUS_TPU_FAULT_INJECT', 'tile_1:1')
    two = str(tmp_path / 'two')
    runner, stats = run(two, tiles_per_device=2)
    assert runner.batch_size == 4
    assert stats['tiles_done'] == 5 and stats['tiles_failed'] == 0
    assert runner.manifest.status('tile_1') == 'done'
    for f in glob.glob(os.path.join(one, '*', '*.tif')):
        with TiffReader(f) as ra, TiffReader(
                os.path.join(two, os.path.relpath(f, one))) as rb:
            np.testing.assert_array_equal(ra.read(), rb.read(), err_msg=f)
    # a tile that keeps failing is marked failed
    monkeypatch.setenv('PROTEUS_TPU_FAULT_INJECT', 'tile_0:9')
    runner, stats = run(str(tmp_path / 'bad'), max_retries=1)
    assert stats['tiles_failed'] == 1
    assert runner.manifest.status('tile_0') == 'failed'


def test_reader_places_tiles_on_their_share(tiles, tmp_path, monkeypatch):
    """Each tile is read onto the device of its share of the batch: over 2
    devices of 2 tiles, tiles 0-1 on the first, 2-3 on the second, and the
    last batch's one tile on the first."""
    _, dirs, anc = tiles
    mesh = [torch.device('cpu', k) for k in range(2)]
    seen = {}
    read = tcampaign._read_tile

    def spy(job, *args):
        seen[job.tile_id] = args[-1]
        return read(job, *args)
    monkeypatch.setattr(tcampaign, '_read_tile', spy)
    tcampaign.ANCILLARY_CACHE.clear()
    runner = tcampaign.CampaignRunner(mesh=mesh, tiles_per_device=2)
    out = str(tmp_path / 'out')
    stats = runner.run(_jobs(tcampaign, dirs[:5], anc, out))
    assert stats['tiles_done'] == 5 and stats['tiles_failed'] == 0
    assert seen == {'tile_0': mesh[0], 'tile_1': mesh[0],
                    'tile_2': mesh[1], 'tile_3': mesh[1],
                    'tile_4': mesh[0]}
    tcampaign.ANCILLARY_CACHE.clear()


def test_ancillary_cache_single_flight():
    import threading
    cache = tcampaign._AncillaryCache(max_entries=4)
    calls = []
    barrier = threading.Barrier(4, timeout=10)

    def compute():
        calls.append(1)
        threading.Event().wait(0.05)
        return object()

    results = []

    def worker():
        barrier.wait()
        results.append(cache.get('k', compute))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert len(calls) == 1 and len(results) == 4
    assert all(r is results[0] for r in results)


def test_read_tile_reuses_ancillaries(tiles):
    """Two reads of one grid share the DEM warp, LAND and ocean mask."""
    _, dirs, anc = tiles
    tcampaign.ANCILLARY_CACHE.clear()
    job = _jobs(tcampaign, dirs[:1], anc, '/nonexistent')[0]
    d1 = tcampaign._read_tile(job, config=DswxChainConfig())
    d2 = tcampaign._read_tile(job, config=DswxChainConfig())
    for key in ('dem', 'landcover_mask', 'shadow_layer', 'ocean_mask'):
        assert isinstance(d1[key], torch.Tensor) and d2[key] is d1[key]
    tcampaign.ANCILLARY_CACHE.clear()


def test_tiles_per_device_default(monkeypatch):
    assert tcampaign.CampaignRunner(mesh=CPU8).tiles_per_device == 1
    assert tcampaign.CampaignRunner(
        mesh=CPU8, tiles_per_device=3).batch_size == 24
    monkeypatch.setattr(tcampaign, 'make_tile_mesh',
                        lambda devices: [torch.device('cuda', 0)])
    runner = tcampaign.CampaignRunner(scaled_inputs=True)
    assert runner.tiles_per_device == \
        tcampaign.CUDA_DEFAULT_TILES_PER_DEVICE
    assert runner.device_scale is True
    monkeypatch.setenv('PROTEUS_TPU_DEVICE_SCALE', '0')
    assert tcampaign.CampaignRunner(scaled_inputs=True).device_scale is False


# ---- the CLI ---------------------------------------------------------------

def test_cli_hosts_runs(tiles, tmp_path, monkeypatch):
    """``--hosts 2`` sends the tiles to worker processes
    (``parallel/dispatch.py``), and every product equals the ``--hosts 1``
    run's. (tests/test_torch_dispatch.py holds the dispatch itself.)"""
    import functools
    from proteus_tpu_torch.parallel import dispatch
    _, dirs, anc = tiles
    monkeypatch.setenv('PROTEUS_TPU_TORCH_DEVICE', 'cpu')
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    # a worker that hangs fails the test instead of stalling it
    monkeypatch.setattr(dispatch, 'dispatch_campaign', functools.partial(
        dispatch.dispatch_campaign, timeout=240, max_host_failures=0))
    common = ['--dem', anc['dem_file'], '--tiles-per-device', '2']
    outs = {}
    for label, hosts in (('one', '1'), ('many', '2')):
        outs[label] = str(tmp_path / label)
        stats = str(tmp_path / f'{label}.json')
        tcampaign.ANCILLARY_CACHE.clear()
        tcli.main(dirs[:3] + ['-o', outs[label], '--stats-json', stats]
                  + common + ['--hosts', hosts])
        import json
        with open(stats) as fh:
            got = json.load(fh)
        assert got['tiles_done'] == 3 and got['tiles_failed'] == 0
    want = sorted(glob.glob(os.path.join(outs['one'], '*', '*.tif')))
    assert len(want) == 3 * 9  # no landcover given: no LAND
    for wf in want:
        gf = os.path.join(outs['many'], os.path.relpath(wf, outs['one']))
        with TiffReader(wf) as rw, TiffReader(gf) as rg:
            np.testing.assert_array_equal(rg.read(), rw.read(), err_msg=gf)
        assert compare_dswx_hls_products(wf, gf), gf
    specs = glob.glob(os.path.join(outs['many'], '.dispatch', 'host*_r0.json'))
    assert len(specs) == 2
    tcampaign.ANCILLARY_CACHE.clear()


def test_cli_runs_the_otsu_shadow(tiles, tmp_path, monkeypatch):
    """--shadow-masking-algorithm otsu with a DEM no longer raises: the
    campaign writes SHAD, and it differs from the default algorithm's
    (tests/test_torch_otsu.py holds it against the single-tile runs)."""
    _, dirs, anc = tiles
    monkeypatch.setenv('PROTEUS_TPU_TORCH_DEVICE', 'cpu')
    shads = {}
    for alg in ('otsu', 'sun_local_inc_angle'):
        out = str(tmp_path / alg)
        tcampaign.ANCILLARY_CACHE.clear()
        tcli.main(dirs[:1] + ['-o', out, '--dem', anc['dem_file'],
                              '--shadow-masking-algorithm', alg])
        files = glob.glob(os.path.join(out, '*', '*_SHAD.tif'))
        assert len(files) == 1
        with TiffReader(files[0]) as r:
            shads[alg] = r.read()
    assert set(np.unique(shads['otsu']).tolist()) <= {0, 1}
    assert (shads['otsu'] != shads['sun_local_inc_angle']).any()


_CLI_SCRIPT = r'''
import glob, os, sys, tempfile
from proteus_tpu_torch.testing import synthetic
from proteus_tpu_torch.cli.dswx_campaign import main
with tempfile.TemporaryDirectory() as root:
    dirs = []
    for t in range(3):
        d = os.path.join(root, f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=48, seed=40 + t)
        dirs.append(d)
    dem = synthetic.make_dem(root, size=48)
    shore = synthetic.make_shoreline(root, size=48)
    out = os.path.join(root, 'out')
    main(dirs + ['-o', out, '--dem', dem, '--shoreline', shore,
                 '--ocean-masking-distance-km', '0.3', '--browse',
                 '--scaled', '--tiles-per-device', '2',
                 '--mask-adjacent-to-cloud-mode', 'cover'])
    n = len(glob.glob(os.path.join(out, '*', '*.tif')))
    assert n == 3 * 10, n
sys.stdout = sys.__stdout__
print('proteus_tpu loaded:', sorted(m for m in sys.modules
                                    if m.split('.')[0] == 'proteus_tpu'))
print('jax loaded:', 'jax' in sys.modules)
'''


def test_campaign_cli_loads_neither_jax_nor_proteus_tpu():
    env = dict(os.environ, PROTEUS_TPU_TORCH_DEVICE='cpu', PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _CLI_SCRIPT], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-2:] == [
        'proteus_tpu loaded: []', 'jax loaded: False']
