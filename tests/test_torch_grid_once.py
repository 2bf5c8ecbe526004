"""What depends only on a campaign's grid is built once a pass.

- ``io/cog.py::PAYLOAD_CACHE`` is single flight: of four writers of one
  key, one builds the payload and three wait for it, and every file is the
  bytes of an uncached ``write_cog``; a failed build raises in every
  waiter and leaves no entry, so the next writer builds again; with no
  room every writer builds its own;
- ``payload_cache_key`` forms the key from a shape and a dtype alone, a
  tensor's as its host array's, as ``build_payload`` sees the array;
- the campaign's writer copies a grid's DEM and LAND to the host only in
  the writer that builds their payloads;
- ``parallel/campaign.py::_AncillaryCache`` evicts the least recently
  used key, one-off keys first: on a time series's keys each grid key is
  computed once, also where four reads of a cold grid hold six keys at
  once; on a continental pass (no key recurs) it misses exactly where a
  FIFO would;
- a CPU campaign of one grid writes the same bytes with the payload cache
  on and off, and counts two payload builds a pass with it on.
"""

import glob
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import synthetic
from proteus_tpu_torch.io import cog
from proteus_tpu_torch.parallel import campaign
from proteus_tpu_torch.runtime import profiling

SIZE = 64
WRITERS = 4
# the products' processing time, fixed so that two runs write the same bytes
FIXED = {'PROCESSING_DATETIME': '2026-01-01T00:00:00Z'}


def _counted():
    """The payload counters moved since this call, as a function."""
    before = profiling.COUNTERS.snapshot()

    def moved():
        return {k.split('.')[1]: v for k, v in profiling.Counters.delta(
            profiling.COUNTERS.snapshot(), before).items()
            if k.startswith('cog_payload.')}
    return moved


def _layer(dtype):
    rng = np.random.default_rng(27)
    if dtype == np.float32:
        return rng.normal(300, 80, (SIZE + 7, SIZE)).astype(np.float32)
    return rng.integers(0, 8, (SIZE + 7, SIZE)).astype(dtype)


def _bytes(path):
    with open(path, 'rb') as fh:
        return fh.read()


@pytest.fixture
def payloads():
    cog.PAYLOAD_CACHE.clear()
    yield cog.PAYLOAD_CACHE
    cog.PAYLOAD_CACHE.clear()


def _wait_for(moved, kind, n):
    deadline = time.monotonic() + 10
    while moved().get(kind, 0) < n:
        assert time.monotonic() < deadline, moved()
        time.sleep(0.001)


# ---- the payload cache ------------------------------------------------------

@pytest.mark.parametrize('dtype', [np.float32, np.uint8])
@pytest.mark.parametrize('entry', ['array', 'tensor'])
def test_four_writers_of_one_key_build_once(tmp_path, payloads, dtype,
                                            entry):
    """The first writer builds while the other three wait for it; each
    file is what an uncached ``write_cog`` writes, with its own tags. A
    tensor is claimed as the campaign's writer claims it."""
    arr = _layer(dtype)
    moved = _counted()
    builds = []

    def slow_build():
        builds.append(1)
        _wait_for(moved, 'wait', WRITERS - 1)
        return cog.build_payload(arr)

    def write(k):
        path = str(tmp_path / f'w{k}.tif')
        if entry == 'array':
            claim = cog.PAYLOAD_CACHE.claim(cog.payload_cache_key(
                ('grid', 1), arr.shape, arr.dtype))
        else:
            claim = campaign._grid_claim(('grid', 1), torch.from_numpy(arr))
        with claim:
            plans = claim.plans(slow_build)
        cog.write_cog(path, None, payload=plans, epsg=32615,
                      metadata={'WRITER': str(k)},
                      geotransform=(600000, 30, 0, 4500000, 0, -30))
        return path

    with ThreadPoolExecutor(WRITERS) as pool:
        paths = list(pool.map(write, range(WRITERS), timeout=30))
    assert len(builds) == 1
    assert moved() == {'miss': 1, 'wait': WRITERS - 1}
    for k, path in enumerate(paths):
        plain = str(tmp_path / f'plain{k}.tif')
        cog.write_cog(plain, arr, epsg=32615, metadata={'WRITER': str(k)},
                      geotransform=(600000, 30, 0, 4500000, 0, -30))
        assert _bytes(path) == _bytes(plain)
    assert len({_bytes(p) for p in paths}) == WRITERS


@pytest.mark.parametrize('failure', ['make_raises', 'left_unbuilt'])
def test_a_failed_build_raises_in_every_waiter(payloads, failure):
    """The builder's error reaches the three waiters; the key has no entry
    after it, so the next writer builds the payload again."""
    arr = _layer(np.uint8)
    key = cog.payload_cache_key(('grid', 2), arr.shape, arr.dtype)
    moved = _counted()
    errors = []

    def builder():
        with cog.PAYLOAD_CACHE.claim(key) as claim:
            assert claim.builds
            _wait_for(moved, 'wait', WRITERS - 1)
            if failure == 'make_raises':
                claim.plans(lambda: 1 / 0)
            # else: the builder leaves without building

    def waiter():
        with cog.PAYLOAD_CACHE.claim(key) as claim:
            assert not claim.builds
            try:
                claim.plans(lambda: pytest.fail('a waiter built'))
            except (ZeroDivisionError, RuntimeError) as e:
                errors.append(type(e))

    with ThreadPoolExecutor(WRITERS) as pool:
        first = pool.submit(builder)
        while key not in payloads._entries:
            time.sleep(0.001)
        waiters = [pool.submit(waiter) for _ in range(WRITERS - 1)]
        for w in waiters:
            w.result(timeout=30)
        if failure == 'make_raises':
            with pytest.raises(ZeroDivisionError):
                first.result(timeout=30)
        else:
            first.result(timeout=30)
    expected = ZeroDivisionError if failure == 'make_raises' \
        else RuntimeError
    assert errors == [expected] * (WRITERS - 1)
    assert payloads._entries == {} and payloads._order == []
    with cog.PAYLOAD_CACHE.claim(key) as claim:
        assert claim.builds
        plans = claim.plans(lambda: cog.build_payload(arr))
    assert plans[0].height == arr.shape[0]
    assert moved() == {'miss': 2, 'wait': WRITERS - 1}


def test_with_no_room_every_writer_builds(tmp_path, payloads, monkeypatch):
    """PROTEUS_TPU_COG_PAYLOAD_CACHE=0: concurrent writers of one key
    each build their own payload and none waits on another's."""
    monkeypatch.setenv('PROTEUS_TPU_COG_PAYLOAD_CACHE', '0')
    arr = _layer(np.float32)
    key = cog.payload_cache_key(('grid', 3), arr.shape, arr.dtype)
    moved = _counted()
    barrier = threading.Barrier(WRITERS, timeout=10)

    def write(k):
        with cog.PAYLOAD_CACHE.claim(key) as claim:
            barrier.wait()
            assert claim.builds
            plans = claim.plans(lambda: cog.build_payload(arr))
        cog.write_cog(str(tmp_path / f'n{k}.tif'), None, epsg=4326,
                      payload=plans)
    with ThreadPoolExecutor(WRITERS) as pool:
        list(pool.map(write, range(WRITERS), timeout=30))
    assert moved() == {'miss': WRITERS}
    assert payloads._entries == {}


def test_a_hit_moves_its_key_to_the_back(payloads):
    """Four keys fill the cache; a hit on the oldest keeps it past the
    next insert, which evicts the least recently used instead."""
    def build(k):
        with cog.PAYLOAD_CACHE.claim(k) as claim:
            claim.plans(lambda: [])
    for k in 'abcd':
        build(k)
    build('a')
    build('e')
    assert payloads._order == ['c', 'd', 'a', 'e']
    assert set(payloads._entries) == {'a', 'c', 'd', 'e'}


@pytest.mark.parametrize('shape,dtype', [
    ((SIZE, SIZE + 3), torch.float32), ((SIZE, SIZE), torch.uint8),
    ((SIZE, SIZE), torch.bool)])
def test_a_tensors_key_is_its_arrays(tmp_path, payloads, shape, dtype):
    """The campaign's key of a device tensor, from its shape and dtype, is
    the key of the tensor's host array as ``build_payload`` sees it (a
    plane as one sample, bool as uint8): the array's claim hits the
    payload the tensor's claim built, and the payload is the array's."""
    t = (torch.arange(shape[0] * shape[1]) % 7).reshape(shape).to(dtype)
    arr = t.numpy()
    with campaign._grid_claim(('grid', 4), t) as claim:
        assert claim.builds
        claim.plans(lambda: cog.build_payload(arr))
    samples = cog._samples(arr)
    moved = _counted()
    with cog.PAYLOAD_CACHE.claim(cog.payload_cache_key(
            ('grid', 4), samples.shape, samples.dtype)) as claim:
        plans = claim.plans(lambda: pytest.fail('built again'))
    assert moved() == {'hit': 1}
    cog.write_cog(str(tmp_path / 'k.tif'), arr, payload=plans)


# ---- the campaign's writer ---------------------------------------------------

def _science():
    layers = {name: np.zeros((SIZE, SIZE), np.uint8)
              for name in ('WTR', 'BWTR', 'CONF', 'WTR-1', 'WTR-2', 'CLOUD')}
    layers['DIAG'] = np.zeros((SIZE, SIZE), np.uint16)
    return layers


@pytest.mark.parametrize('concurrent', [False, True])
def test_only_the_builder_copies_the_grid_to_the_host(tmp_path, payloads,
                                                      monkeypatch,
                                                      concurrent):
    """Four products of one grid: the DEM and LAND tensors are each copied
    out once, by the writer that builds their payloads; every product
    holds both layers, with its own metadata."""
    from proteus_tpu_torch.io.tiff import TiffReader
    dem = torch.linspace(0, 800, SIZE * SIZE).reshape(SIZE, SIZE)
    land = (torch.arange(SIZE * SIZE) % 5).reshape(SIZE, SIZE).to(
        torch.uint8)
    copied = []
    to_host = campaign.to_host

    def spy(t, site):
        copied.append(next(name for name, v in (('DEM', dem),
                                                ('LAND', land))
                           if v is t))
        return to_host(t, site)
    monkeypatch.setattr(campaign, 'to_host', spy)
    gt = (600000, 30, 0, 4500000, 0, -30)
    grid = dict(geotransform=gt, projection='EPSG:32615', length=SIZE,
                width=SIZE, dem=dem, landcover_mask=land,
                dem_payload_key=('dem_warp', 'sig', gt, SIZE),
                landcover_payload_key=('landcover', 'sig', gt, SIZE))

    def write(i):
        job = campaign.TileJob(f't{i}', [], str(tmp_path / f't{i}'))
        return campaign._write_tile(job, _science(), dict(grid),
                                    {'SENSING_TIME': f'T{i}'})
    moved = _counted()
    if concurrent:
        with ThreadPoolExecutor(WRITERS) as pool:
            list(pool.map(write, range(WRITERS), timeout=60))
    else:
        for i in range(WRITERS):
            write(i)
    assert sorted(copied) == ['DEM', 'LAND']
    got = moved()
    assert got['miss'] == 2
    assert got.get('hit', 0) + got.get('wait', 0) == 2 * (WRITERS - 1)
    if not concurrent:
        assert got['hit'] == 2 * (WRITERS - 1)
    for i in range(WRITERS):
        for layer, want in (('DEM', dem), ('LAND', land)):
            (tif,) = glob.glob(str(tmp_path / f't{i}' / f'*_{layer}.tif'))
            with TiffReader(tif) as r:
                np.testing.assert_array_equal(r.read(), want.numpy())
                assert r.metadata()['SENSING_TIME'] == f'T{i}'


# ---- the ancillary cache ------------------------------------------------------

def _misses(cache, keys):
    computed = []
    for key in keys:
        cache.get(key, lambda key=key: computed.append(key) or key)
    return computed


class _Fifo:
    """The parent's eviction, as a model: the oldest computed key goes.
    With ``refresh``, a hit moves its key to the back: a plain LRU."""

    def __init__(self, cap, refresh=False):
        self.cap, self.refresh, self.keys = cap, refresh, []

    def misses(self, keys):
        computed = []
        for key in keys:
            if key in self.keys:
                if self.refresh:
                    self.keys.remove(key)
                    self.keys.append(key)
                continue
            computed.append(key)
            self.keys.append(key)
            del self.keys[:-self.cap]
        return computed


def _timeseries(tiles, landcover_first, wave=1):
    """The keys 8 reads of one grid use, in waves of ``wave`` reads that
    run at once: each read of a wave takes the grid's two keys (the first
    computes them, the others wait), then each its own shadow."""
    keys = []
    for w in range(0, tiles, wave):
        grid = [('dem_warp', 'g'), ('landcover', 'g')]
        keys += (grid[::-1] if landcover_first else grid) * wave
        keys += [('shadow', 'g', k) for k in range(w, w + wave)]
    return keys


@pytest.mark.parametrize('cap', [3, 4])
@pytest.mark.parametrize('landcover_first', [False, True])
@pytest.mark.parametrize('wave', [1, 2, 4])
def test_lru_computes_each_grid_key_once_in_a_time_series(cap,
                                                          landcover_first,
                                                          wave):
    """Also with four reads at once (a batch and its prefetch), which hold
    the grid's two keys and four shadows: more than four keys, so a plain
    LRU would evict the grid's keys for the newer shadows."""
    keys = _timeseries(8, landcover_first, wave)
    computed = _misses(campaign._AncillaryCache(max_entries=cap), keys)
    assert computed.count(('dem_warp', 'g')) == 1
    assert computed.count(('landcover', 'g')) == 1
    assert sorted(k[2] for k in computed if k[0] == 'shadow') == \
        list(range(8))
    # the parent's FIFO computed the grid's two warps again, and so does
    # a plain LRU where a wave holds more keys than the cache
    fifo = _Fifo(cap).misses(keys)
    assert len(fifo) > len(computed)
    lru = _Fifo(cap, refresh=True).misses(keys)
    assert (len(lru) > len(computed)) == (2 + wave > cap)


@pytest.mark.parametrize('cap', [1, 2, 3, 4])
def test_lru_misses_as_fifo_where_no_key_recurs(cap):
    """A continental pass (8 grids, each read once) and a second pass after
    it: the LRU computes exactly the keys a FIFO computes."""
    keys = [(kind, g) for _ in range(2) for g in range(8)
            for kind in ('dem_warp', 'shadow', 'landcover')]
    assert _misses(campaign._AncillaryCache(max_entries=cap), keys) == \
        _Fifo(cap).misses(keys)


def test_concurrent_readers_of_a_time_series_keep_the_grid_keys():
    """Four threads each read two tiles of one grid at once (a batch and
    its prefetch): the grid's two keys are computed once."""
    cache = campaign._AncillaryCache(max_entries=4)
    computed = []
    lock = threading.Lock()

    def compute(key):
        with lock:
            computed.append(key)
        time.sleep(0.01)
        return key

    def read(k):
        for key in (('dem_warp', 'g'), ('shadow', 'g', k),
                    ('landcover', 'g')):
            cache.get(key, lambda key=key: compute(key))

    for batch in range(4):
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(read, (2 * batch, 2 * batch + 1), timeout=30))
    assert computed.count(('dem_warp', 'g')) == 1
    assert computed.count(('landcover', 'g')) == 1


# ---- a CPU campaign -----------------------------------------------------------

@pytest.fixture(scope='module')
def grid(tmp_path_factory):
    root = tmp_path_factory.mktemp('grid_once_tiles')
    dirs = []
    for t in range(4):
        d = str(root / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=SIZE, seed=2700 + t)
        dirs.append(d)
    anc = dict(dem_file=synthetic.make_dem(str(root), size=SIZE),
               landcover_file=synthetic.make_landcover(str(root), size=SIZE),
               worldcover_file=synthetic.make_worldcover(str(root),
                                                         size=SIZE))
    return dirs, anc


def _campaign(grid, out, cache_entries, monkeypatch):
    """Two passes of the grid's four tiles from cleared caches: the stats
    of each pass and the bytes of every file, by its path under ``out``."""
    dirs, anc = grid
    monkeypatch.setenv('PROTEUS_TPU_COG_PAYLOAD_CACHE', str(cache_entries))
    runner = campaign.CampaignRunner(mesh=[torch.device('cpu')],
                                     tiles_per_device=2, save_browse=True)
    enabled = campaign.STAGE_TIMES.enabled
    campaign.STAGE_TIMES.reset()
    campaign.STAGE_TIMES.enabled = True
    stats = []
    try:
        for p in range(2):
            campaign.ANCILLARY_CACHE.clear()
            cog.PAYLOAD_CACHE.clear()
            jobs = [campaign.TileJob(
                f'tile_{t}.p{p}', sorted(glob.glob(os.path.join(d, '*.tif'))),
                os.path.join(out, f'p{p}', f'tile_{t}'),
                product_id=f'tile_{t}', **anc) for t, d in enumerate(dirs)]
            stats.append(runner.run(jobs, metadata=FIXED))
        calls = {k: v['calls'] for k, v in campaign.STAGE_TIMES.table().items()}
    finally:
        campaign.STAGE_TIMES.enabled = enabled
        campaign.ANCILLARY_CACHE.clear()
        cog.PAYLOAD_CACHE.clear()
    files = {os.path.relpath(f, out): _bytes(f)
             for f in glob.glob(os.path.join(out, '*', '*', '*'))}
    return stats, calls, files


def test_a_campaign_writes_the_same_bytes_with_the_cache_on_and_off(
        grid, tmp_path, monkeypatch):
    on, on_calls, on_files = _campaign(grid, str(tmp_path / 'on'), 4,
                                       monkeypatch)
    off, off_calls, off_files = _campaign(grid, str(tmp_path / 'off'), 0,
                                          monkeypatch)
    assert [s['tiles_done'] for s in on + off] == [4] * 4
    assert len(on_files) == 2 * 4 * 12
    assert on_files == off_files
    for s_on, s_off in zip(on, off):
        c_on, c_off = s_on['counters'], s_off['counters']
        # the cache on: the DEM and LAND are built once a pass
        assert c_on['cog_payload.miss'] == 2
        assert c_on.get('cog_payload.hit', 0) \
            + c_on.get('cog_payload.wait', 0) == 6
        # off: every write builds its own, none shares another's
        assert c_off['cog_payload.miss'] == 8
        assert 'cog_payload.hit' not in c_off
        assert 'cog_payload.wait' not in c_off
        for c in (c_on, c_off):
            assert {k: v for k, v in c.items()
                    if k.startswith('anc.') and k.endswith('.miss')} == {
                'anc.dem_warp.miss': 1, 'anc.landcover.miss': 1,
                'anc.shadow.miss': 1}
    # only the DEM's builder copies it out
    assert (on_calls['write_d2h_dem'], off_calls['write_d2h_dem']) == (2, 8)
    assert on_calls['write_cog_dem_float32'] == \
        off_calls['write_cog_dem_float32'] == 8
    assert on_calls['write_cog_land'] == off_calls['write_cog_land'] == 8


# ---- both caches under contention ---------------------------------------------

@pytest.mark.parametrize('cap', [2, 4])
@pytest.mark.parametrize('kind', ['payload', 'ancillary'])
@pytest.mark.parametrize('evicting', [False, True])
def test_many_threads_on_few_keys_keep_the_tables_whole(payloads, monkeypatch,
                                                        kind, cap, evicting):
    """More threads than cores get keys in turn, with the interpreter
    switching threads as often as it can: every call returns its key's
    value, and the order and the entries name the same keys, at most
    ``cap``. With room for every key in use each is made once; with six
    keys, evicted ones are made again."""
    import sys
    n_keys = 6 if evicting else cap
    threads = 4 * (os.cpu_count() or 1) + 4
    made = []
    lock = threading.Lock()

    def make(key):
        with lock:
            made.append(key)
        return [key]

    if kind == 'payload':
        monkeypatch.setenv('PROTEUS_TPU_COG_PAYLOAD_CACHE', str(cap))
        cache = payloads

        def get(key):
            with cache.claim(key) as claim:
                return claim.plans(lambda: make(key))
    else:
        cache = campaign._AncillaryCache(max_entries=cap)

        def get(key):
            return cache.get(key, lambda: make(key))

    def worker(k):
        return all(get(('grid', (k + i) % n_keys)) == [('grid', (k + i)
                                                         % n_keys)]
                   for i in range(50))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(threads) as pool:
            assert all(pool.map(worker, range(threads), timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert sorted(cache._order) == sorted(cache._entries)
    assert len(cache._order) <= cap
    assert set(getattr(cache, '_reused', ())) <= set(cache._order)
    if evicting:
        assert len(made) > n_keys
    else:
        assert sorted(made) == [('grid', k) for k in range(n_keys)]
