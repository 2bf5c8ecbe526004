"""Multi-host dispatch of the port (``dswx_campaign --hosts N``), the twin
of tests/test_dispatch.py: the shard, spec and merge units against
proteus_tpu's, the cards each worker is given, a 2-process run on the CPU
whose product files equal the one-process run's and those of proteus_tpu's
own dispatch (JAX on the CPU), tolerance 0, and a killed worker whose tiles
are run again. Every worker process has a time limit.
"""

import glob
import json
import os
import subprocess

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.parallel import campaign as jcampaign
from proteus_tpu.parallel import dispatch as jdispatch
from proteus_tpu_torch.parallel import campaign as tcampaign
from proteus_tpu_torch.parallel import dispatch
from proteus_tpu_torch.runtime.compare import compare_dswx_hls_products

torch.set_num_threads(1)

WORKER_TIMEOUT = 240


# ---- units -------------------------------------------------------------------

@pytest.mark.parametrize('n_hosts', [1, 2, 3, 5])
def test_host_shard_matches_jax(n_hosts):
    jobs = [tcampaign.TileJob(f't{i}', [], '/tmp') for i in range(7)]
    shards = [dispatch.host_shard(jobs, k, n_hosts) for k in range(n_hosts)]
    for k, shard in enumerate(shards):
        assert [j.tile_id for j in shard] == [
            j.tile_id for j in jdispatch.host_shard(jobs, k, n_hosts)]
        assert [j.tile_id for j in shard] == [
            f't{i}' for i in range(k, 7, n_hosts)]
    ids = [j.tile_id for shard in shards for j in shard]
    assert sorted(ids) == sorted(j.tile_id for j in jobs)


def test_job_roundtrip_matches_jax():
    assert dispatch._JOB_FIELDS == jdispatch._JOB_FIELDS
    kw = dict(dem_file='/dem.tif', ocean_masking_shoreline_distance_km=2.5,
              product_id='p', shoreline_shapefile='/s.shp')
    job = tcampaign.TileJob('tx', ['/a.tif'], '/out', **kw)
    as_dict = dispatch.job_to_dict(job)
    assert as_dict == jdispatch.job_to_dict(
        jcampaign.TileJob('tx', ['/a.tif'], '/out', **kw))
    assert json.loads(json.dumps(as_dict)) == as_dict
    back = dispatch.job_from_dict(as_dict)
    assert isinstance(back, tcampaign.TileJob)
    for f in dispatch._JOB_FIELDS:
        assert getattr(back, f) == getattr(job, f)


def test_manifest_paths_and_merge_prefers_done(tmp_path):
    mp = str(tmp_path / 'manifest.json')
    for k in range(3):
        assert dispatch.host_manifest_path(mp, k) == \
            jdispatch.host_manifest_path(mp, k)
    assert dispatch.host_manifest_path('m', 1) == 'm.host1.json'
    a = tcampaign.CampaignManifest(dispatch.host_manifest_path(mp, 0))
    a.mark('t0', 'done')
    a.mark('t1', 'failed', error='io')
    b = tcampaign.CampaignManifest(dispatch.host_manifest_path(mp, 1))
    b.mark('t1', 'done')
    b.mark('t2', 'failed', error='io')
    merged = dispatch.merge_manifests(mp, 2)
    assert {k: v['status'] for k, v in merged.state.items()} == {
        't0': 'done', 't1': 'done', 't2': 'failed'}
    jmerged = jdispatch.merge_manifests(mp, 2)
    assert {k: v['status'] for k, v in jmerged.state.items()} == {
        k: v['status'] for k, v in merged.state.items()}


# ---- the cards a worker is given ---------------------------------------------

@pytest.mark.parametrize('n_cards', [1, 2, 4])
@pytest.mark.parametrize('n_workers', [1, 2, 3, 4, 6])
def test_worker_devices_share_the_cards(n_cards, n_workers):
    """With ``cuda`` the visible cards are dealt round-robin: no card goes
    to two workers while there is a card a worker, every card is used, and
    with fewer cards than workers the workers left over share one."""
    subsets = [dispatch.worker_devices('cuda', k, n_workers, n_cards)
               for k in range(n_workers)]
    assert all(subsets)
    for subset in subsets:
        assert all(d in {f'cuda:{c}' for c in range(n_cards)}
                   for d in subset)
    dealt = [d for subset in subsets for d in subset]
    assert set(dealt) == {f'cuda:{c}' for c in range(min(n_cards,
                                                         n_workers * n_cards))}
    if n_cards >= n_workers:
        assert len(dealt) == len(set(dealt)) == n_cards   # disjoint
        if n_workers > 1:
            assert all(len(s) < n_cards for s in subsets)
    else:
        assert all(len(s) == 1 for s in subsets)
        assert [s[0] for s in subsets] == [
            f'cuda:{k % n_cards}' for k in range(n_workers)]


def test_worker_devices_other_specs(monkeypatch):
    for k in range(3):
        assert dispatch.worker_devices('cpu', k, 3) == ['cpu']
        assert dispatch.worker_devices('cuda:1', k, 3, n_cards=4) == ['cuda:1']
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert dispatch.worker_devices('cuda', 1, 2) == ['cuda:1', 'cuda:3']
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        dispatch.worker_devices('cuda', 0, 2)


# ---- the spec and the worker ---------------------------------------------------

SIZE = 120


@pytest.fixture(scope='module')
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp('dispatch_ds')
    files, _ = synthetic.make_hls_v2_dataset(str(root), size=SIZE)
    return files


def _jobs(module, files, out_root, n):
    return [module.TileJob(f'tile{i}', files,
                           os.path.join(out_root, f'tile{i}'))
            for i in range(n)]


def _products(root):
    return sorted(os.path.relpath(f, root) for f in
                  glob.glob(os.path.join(root, '*', '*.tif')))


def _assert_same_products(want_root, got_root, n_tiles):
    want = _products(want_root)
    assert want == _products(got_root)
    assert len(want) == 7 * n_tiles   # no DEM, no landcover: 7 layers
    for rel in want:
        with TiffReader(os.path.join(want_root, rel)) as rw, \
                TiffReader(os.path.join(got_root, rel)) as rg:
            np.testing.assert_array_equal(rg.read(), rw.read(), err_msg=rel)
        assert compare_dswx_hls_products(os.path.join(want_root, rel),
                                         os.path.join(got_root, rel)), rel


@pytest.fixture
def worker_env(monkeypatch):
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    monkeypatch.setenv('JAX_PLATFORMS', 'cpu')


def test_spec_round_trip_through_the_worker(tiny_dataset, tmp_path,
                                            monkeypatch, capsys):
    """The spec the dispatcher writes is what ``run_host_worker`` reads:
    the jobs, the manifest shard, the config and runner options and the
    worker's devices."""
    written = {}

    class _Done:
        pid = 1

        def wait(self, timeout=None):
            return 0

    def fake_popen(cmd, **kw):
        assert cmd[1:3] == ['-m', 'proteus_tpu_torch.parallel.dispatch']
        with open(cmd[-1]) as fh:
            written[os.path.basename(cmd[-1])] = json.load(fh)
        return _Done()

    monkeypatch.setattr(dispatch.subprocess, 'Popen', fake_popen)
    out_root = str(tmp_path / 'out')
    mp = str(tmp_path / 'manifest.json')
    jobs = _jobs(tcampaign, tiny_dataset, out_root, 3)
    _, stats = dispatch.dispatch_campaign(
        jobs, n_hosts=2, manifest_path=mp,
        scratch_dir=str(tmp_path / 'scratch'), device='cpu',
        config_kwargs=dict(mask_adjacent_to_cloud_mode='cover'),
        save_browse=True, runner_kwargs=dict(tiles_per_device=2),
        max_host_failures=0)
    assert stats == {'tiles_done': 0, 'tiles_failed': 0, 'tiles_total': 3}
    assert sorted(written) == ['host0_r0.json', 'host1_r0.json']
    spec = written['host0_r0.json']
    assert spec['device'] == 'cpu' and spec['devices'] == ['cpu']
    assert [j['tile_id'] for j in spec['jobs']] == ['tile0', 'tile2']
    assert spec['manifest_path'] == dispatch.host_manifest_path(mp, 0)
    assert spec['config_kwargs'] == {'mask_adjacent_to_cloud_mode': 'cover'}
    assert spec['save_browse'] is True
    assert spec['runner_kwargs'] == {'tiles_per_device': 2}
    # the worker, in this process, on host 1's spec
    spec_path = str(tmp_path / 'scratch' / 'host1_r0.json')
    monkeypatch.setenv('PROTEUS_TPU_TORCH_DEVICE', 'cuda')
    assert dispatch.run_host_worker(spec_path) == 0
    assert os.environ['PROTEUS_TPU_TORCH_DEVICE'] == 'cpu'  # the spec's
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        'worker_stats']['tiles_done'] == 1
    shard = tcampaign.CampaignManifest(dispatch.host_manifest_path(mp, 1))
    assert shard.status('tile1') == 'done'
    assert os.path.isfile(os.path.join(out_root, 'tile1',
                                       'dswx_hls_v0.1_BROWSE.png'))


# ---- two worker processes ------------------------------------------------------

def test_two_hosts_match_one_host_and_jax_dispatch(tiny_dataset, tmp_path,
                                                   worker_env):
    n = 4
    one = str(tmp_path / 'one')
    runner = tcampaign.CampaignRunner(mesh=[torch.device('cpu')],
                                      manifest_path=None)
    assert runner.run(_jobs(tcampaign, tiny_dataset, one, n))[
        'tiles_done'] == n
    two = str(tmp_path / 'two')
    mp = str(tmp_path / 'manifest.json')
    merged, stats = dispatch.dispatch_campaign(
        _jobs(tcampaign, tiny_dataset, two, n), n_hosts=2, manifest_path=mp,
        scratch_dir=str(tmp_path / 'scratch'), device='cpu',
        timeout=WORKER_TIMEOUT)
    assert stats == {'tiles_done': n, 'tiles_failed': 0, 'tiles_total': n}
    assert sorted(merged.state) == [f'tile{i}' for i in range(n)]
    for k in range(2):   # each host kept its own ledger, of its own tiles
        shard = tcampaign.CampaignManifest(dispatch.host_manifest_path(mp, k))
        assert sorted(shard.state) == [f'tile{i}' for i in range(k, n, 2)]
    assert not os.path.exists(str(tmp_path / 'scratch' / 'host0_r1.json'))
    _assert_same_products(one, two, n)
    # proteus_tpu's own dispatch, two JAX worker processes on the CPU
    jax_out = str(tmp_path / 'jax')
    _, jstats = jdispatch.dispatch_campaign(
        _jobs(jcampaign, tiny_dataset, jax_out, n), n_hosts=2,
        manifest_path=str(tmp_path / 'jmanifest.json'),
        scratch_dir=str(tmp_path / 'jscratch'), platform='cpu',
        timeout=WORKER_TIMEOUT)
    assert jstats == stats
    _assert_same_products(jax_out, two, n)


def test_killed_worker_tiles_are_rerun(tiny_dataset, tmp_path, monkeypatch,
                                       worker_env):
    """Host 0's worker is killed as it starts: its tiles are not done after
    round 0, one worker runs them again in round 1, and host 1's finished
    tiles are left alone."""
    real_popen = subprocess.Popen
    killed = []

    def popen(cmd, *a, **k):
        proc = real_popen(cmd, *a, **k)
        if cmd[-1].endswith('host0_r0.json'):
            proc.kill()
            killed.append(proc.pid)
        return proc

    monkeypatch.setattr(dispatch.subprocess, 'Popen', popen)
    out_root = str(tmp_path / 'out')
    mp = str(tmp_path / 'm.json')
    jobs = _jobs(tcampaign, tiny_dataset, out_root, 4)
    merged, stats = dispatch.dispatch_campaign(
        jobs, n_hosts=2, manifest_path=mp,
        scratch_dir=str(tmp_path / 'scratch'), device='cpu',
        timeout=WORKER_TIMEOUT)
    assert len(killed) == 1
    assert stats == {'tiles_done': 4, 'tiles_failed': 0, 'tiles_total': 4}
    with open(str(tmp_path / 'scratch' / 'host0_r1.json')) as fh:
        rerun = json.load(fh)
    assert [j['tile_id'] for j in rerun['jobs']] == ['tile0', 'tile2']
    assert len(_products(out_root)) == 7 * 4
    # a second dispatch finds every tile done and runs nothing again
    wtr = os.path.join(out_root, 'tile1', 'dswx_hls_v0.1_B01_WTR.tif')
    mtime = os.path.getmtime(wtr)
    _, stats = dispatch.dispatch_campaign(
        jobs, n_hosts=2, manifest_path=mp,
        scratch_dir=str(tmp_path / 'scratch2'), device='cpu',
        timeout=WORKER_TIMEOUT)
    assert stats['tiles_done'] == 4 and os.path.getmtime(wtr) == mtime


def test_hung_worker_is_killed_and_recovered(tiny_dataset, tmp_path,
                                             monkeypatch, worker_env):
    """A worker that exceeds the time limit is killed and its tiles run
    again (the case of tests/test_dispatch.py)."""
    real_popen = subprocess.Popen
    hung = {'count': 0, 'killed': 0}

    class _HungProc:
        pid = 99999

        def wait(self, timeout=None):
            if hung['count'] == 0:
                hung['count'] = 1
                raise subprocess.TimeoutExpired('worker', timeout)
            return 0

        def kill(self):
            hung['killed'] += 1

    def fake_popen(cmd, *a, **k):
        if hung['count'] == 0 and cmd[-1].endswith('host0_r0.json'):
            return _HungProc()
        return real_popen(cmd, *a, **k)

    monkeypatch.setattr(dispatch.subprocess, 'Popen', fake_popen)
    jobs = _jobs(tcampaign, tiny_dataset, str(tmp_path / 'out'), 3)
    _, stats = dispatch.dispatch_campaign(
        jobs, n_hosts=2, manifest_path=str(tmp_path / 'm.json'),
        scratch_dir=str(tmp_path / 'scratch'), device='cpu',
        timeout=WORKER_TIMEOUT)
    assert stats['tiles_done'] == 3 and stats['tiles_failed'] == 0
    assert hung == {'count': 1, 'killed': 1}
