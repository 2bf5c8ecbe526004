"""The port's campaign instruments (``proteus_tpu_torch/tools/``) against
the JAX package's tools (``tools/*.py``) on the CPU, at 64-96 px,
tolerance 0:

- ``bench_cold_grid``: its JSON, the ancillary cache's misses (N cold, 1
  warm), and each run's product files byte for byte against the JAX tool's
  ``run_campaign`` (JAX's ``CampaignRunner``) on the same tiles, with a
  fixed processing time;
- ``host_budget``: the JAX tool's stage names and order, and its realistic
  layers against ``tests/oracle.py::full_chain`` on the same ingest;
- ``bench_batch``: the checksum of each B against the JAX kernel in
  interpret mode on the same inputs;
- ``campaign_soak`` and ``soak_back_to_back``: the kill-and-resume soak
  passes, its products equal an uninterrupted campaign's, and the
  back-to-back driver prints its ratio and refuses a stale report.

Every twin runs with the repository root as its working directory, and
the six JSON files the JAX tools write there must be byte for byte as they
were. A JAX tool's ``main`` runs only with ``--out`` in a temporary
directory.
"""

import contextlib
import glob
import hashlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.models.dswx.chain import DswxChainConfig as JaxConfig
from proteus_tpu.ops.pallas.wtr_kernel import make_wtr_kernel
from proteus_tpu.parallel import campaign as jcampaign
from proteus_tpu_torch.cli import dswx_campaign as tcli
from proteus_tpu_torch.io import hls as thls
from proteus_tpu_torch.parallel import campaign as tcampaign
from proteus_tpu_torch.testing import synthetic as tsynthetic
from proteus_tpu_torch.tools import (bench_batch, bench_cold_grid,
                                     campaign_soak, datasets, host_budget,
                                     soak_back_to_back)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_ARTIFACTS = ('COLD_GRID_BENCH.json', 'HOST_BUDGET.json',
                  'BENCH_BATCH.json', 'SOAK_CAMPAIGN.json',
                  'SOAK_CAMPAIGN_SCALED.json', 'SOAK_BACK_TO_BACK.json')
# the products' processing time, fixed so that two runs write the same bytes
FIXED = {'PROCESSING_DATETIME': '2026-01-01T00:00:00Z'}


def _load(name, path):
    """A module loaded from its path (``tools/`` is not a package, and
    ``tests/oracle.py`` stays out of ``sys.modules``); ``sys.path`` is
    restored after the module's own insertions."""
    path_before = list(sys.path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path_before
    return module


def _jax_tool(name):
    return _load(f'jax_{name}', os.path.join(REPO, 'tools', f'{name}.py'))


def _digests():
    out = {}
    for name in ROOT_ARTIFACTS:
        with open(os.path.join(REPO, name), 'rb') as fh:
            out[name] = hashlib.sha256(fh.read()).hexdigest()
    return out


@contextlib.contextmanager
def at_repo_root():
    """Run the block with the repository root as the working directory;
    the six root artifacts of the JAX tools must be unchanged after it."""
    before = _digests()
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(REPO)
        yield
    assert _digests() == before


@contextlib.contextmanager
def fixed_processing_time(module):
    """``module.CampaignRunner.run`` with ``FIXED`` as its metadata."""
    run = module.CampaignRunner.run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module.CampaignRunner, 'run',
                   lambda self, jobs, metadata=None: run(self, jobs, FIXED))
        yield


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith('{')]


# ---- bench_cold_grid --------------------------------------------------------

COLD_SIZE, COLD_TILES = 64, 2


@pytest.fixture(scope='module')
def cold_grid(tmp_path_factory):
    """The twin once on the CPU: 2 cold and 2 warm tiles of 64^2 under a
    named root (kept), its report, and the JSON lines it printed."""
    root = str(tmp_path_factory.mktemp('cold_grid'))
    out = os.path.join(root, 'report.json')
    x0, y0 = tsynthetic.X0, tsynthetic.Y0
    with at_repo_root(), fixed_processing_time(tcampaign), \
            contextlib.redirect_stdout(io.StringIO()) as text:
        assert bench_cold_grid.main(
            ['--device', 'cpu', '--size', str(COLD_SIZE), '--tiles',
             str(COLD_TILES), '--root', root, '--out', out]) == 0
    assert (tsynthetic.X0, tsynthetic.Y0) == (x0, y0)
    with open(out) as fh:
        return root, json.load(fh), _json_lines(text.getvalue())


def test_cold_grid_report(cold_grid):
    root, report, lines = cold_grid
    assert {'generated', 'device', 'tiles', 'size', 'cold', 'warm',
            'cold_over_warm_ratio'} <= set(report)
    assert report['device'] == 'cpu' and report['tiles'] == COLD_TILES
    for label in ('cold', 'warm'):
        row = report[label]
        assert {'tiles', 'seconds', 'tiles_per_min', 'tiles_per_hour',
                'stage_seconds', 'cache_misses',
                'peak_device_memory_bytes'} <= set(row)
        assert row['tiles'] == COLD_TILES and row['seconds'] > 0
        assert row['peak_device_memory_bytes'] is None  # no card
        assert 'read_dem_shadow' in row['stage_seconds']
    assert report['cold_over_warm_ratio'] == pytest.approx(
        report['warm']['tiles_per_min'] / report['cold']['tiles_per_min'])
    assert [ln.get('built') or ln.get('label') or ln['metric']
            for ln in lines] == ['cold', 'cold', 'warm', 'warm',
                                 f'cold_grid_tiles_per_min_{COLD_SIZE}x'
                                 f'{COLD_SIZE}']
    assert lines[-1]['device'] == 'cpu' and lines[-1]['artifact']


@pytest.mark.parametrize('label,misses', [('cold', COLD_TILES),
                                          ('warm', 1)])
def test_cold_grid_cache_misses(cold_grid, label, misses):
    """Every grid is warped once: N misses of each kind cold, 1 warm."""
    _, report, _ = cold_grid
    assert report[label]['cache_misses'] == dict.fromkeys(
        ('dem_warp', 'landcover', 'ocean', 'shadow'), misses)


def test_cold_grids_are_distinct(cold_grid):
    """Each cold tile lies on its own grid; the warm tiles share one."""
    root, _, _ = cold_grid
    gts = {}
    for label in ('cold', 'warm'):
        for d in sorted(glob.glob(os.path.join(root, f'{label}_*'))):
            with TiffReader(datasets.band_files(d)[0]) as r:
                gts.setdefault(label, set()).add(r.geotransform())
    assert len(gts['cold']) == COLD_TILES and len(gts['warm']) == 1


@pytest.mark.parametrize('label', ['cold', 'warm'])
def test_cold_grid_files_match_jax(cold_grid, tmp_path, label):
    """The JAX tool's ``run_campaign`` (JAX's CampaignRunner on its 8 CPU
    devices) over the twin's own tiles: every product file byte for byte
    the twin's."""
    root, _, _ = cold_grid
    build = {'cold': bench_cold_grid.build_cold,
             'warm': bench_cold_grid.build_warm}[label]
    tiles = build(root, COLD_TILES, COLD_SIZE)  # stamped: nothing written
    jcampaign.ANCILLARY_CACHE.clear()
    with fixed_processing_time(jcampaign):
        _jax_tool('bench_cold_grid').run_campaign(tiles, str(tmp_path),
                                                  label)
    want = sorted(glob.glob(os.path.join(str(tmp_path), label, '*', '*')))
    assert len(want) == COLD_TILES * 10  # 7 science layers, LAND, SHAD, DEM
    for wf in want:
        gf = os.path.join(root, os.path.relpath(wf, str(tmp_path)))
        with open(wf, 'rb') as a, open(gf, 'rb') as b:
            assert a.read() == b.read(), gf


def test_cold_grid_reruns_on_a_named_root(cold_grid, tmp_path):
    """A second run over a kept root rewrites no input and ignores the
    first run's manifest: every tile runs again."""
    root, _, _ = cold_grid
    stamps = {p: os.path.getmtime(p) for p in glob.glob(
        os.path.join(root, '*', '.done'))}
    assert len(stamps) == 2 * COLD_TILES + 1
    row = bench_cold_grid.run_campaign(
        bench_cold_grid.build_warm(root, COLD_TILES, COLD_SIZE), root,
        'warm', torch.device('cpu'))
    assert row['tiles'] == COLD_TILES and row['cache_misses']['dem_warp'] == 1
    assert {p: os.path.getmtime(p) for p in stamps} == stamps


def test_bench_e2e_dataset_is_the_writers(tmp_path):
    """The shared writer gives bench_e2e the synthetic writers' own files
    (tile and ancillaries with their default seeds), and a second call
    writes nothing."""
    from proteus_tpu_torch.tools import bench_e2e
    files, extra = bench_e2e.build_dataset(str(tmp_path / 'a'), 48, True)
    want_files, _ = tsynthetic.make_hls_v2_dataset(str(tmp_path / 'b'),
                                                   size=48)
    want = {'dem_file': tsynthetic.make_dem(str(tmp_path / 'b'), size=48),
            'landcover_file': tsynthetic.make_landcover(str(tmp_path / 'b'),
                                                        size=48),
            'worldcover_file': tsynthetic.make_worldcover(
                str(tmp_path / 'b'), size=48)}
    for got, ref in list(zip(files, sorted(want_files))) + [
            (extra[k], v) for k, v in want.items()]:
        assert os.path.basename(got) == os.path.basename(ref)
        with open(got, 'rb') as a, open(ref, 'rb') as b:
            assert a.read() == b.read(), got
    assert os.path.isfile(extra['shoreline_shapefile'])
    mtimes = [os.path.getmtime(f) for f in files]
    assert bench_e2e.build_dataset(str(tmp_path / 'a'), 48, True) == \
        (files, extra)
    assert [os.path.getmtime(f) for f in files] == mtimes


# ---- host_budget ------------------------------------------------------------

def test_host_budget_stages_are_the_jax_tools(tmp_path, capsys):
    """The same stage names in the same order, and the same report keys
    (the codec's name added), as the JAX tool's report."""
    with at_repo_root():
        assert host_budget.main(['--device', 'cpu', '--size', '64',
                                 '--passes', '1']) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    got = lines[0]
    jax_out = str(tmp_path / 'HOST_BUDGET.json')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, 'argv', ['host_budget.py', '--size', '64',
                                 '--passes', '1', '--out', jax_out])
        _jax_tool('host_budget').main()
    capsys.readouterr()
    with open(jax_out) as fh:
        want = json.load(fh)
    assert list(got['stages']) == list(want['stages']) == [
        'ingest_decode', 'unpack_derive', 'cog_uint8_x6', 'cog_uint16_diag',
        'cog_float32_dem', 'png_browse']
    assert list(got['stages_realistic']) == list(want['stages_realistic'])
    assert set(want) | {'device', 'codec', 'metric', 'artifact'} == set(got)
    assert got['codec'].startswith('native') or got['codec'] == 'python'
    assert got['total_core_s_per_tile'] == pytest.approx(
        sum(v['seconds'] for v in got['stages'].values()))


def test_host_budget_realistic_layers_equal_the_oracle(tmp_path):
    """The chain's layers of the tool's tile (seed 42) on the CPU equal
    ``tests/oracle.py::full_chain`` called as the JAX tool calls it."""
    oracle = _load('oracle_by_path', os.path.join(REPO, 'tests', 'oracle.py'))
    from proteus_tpu.core.thresholds import HlsThresholds
    files, _ = tsynthetic.make_hls_v2_dataset(str(tmp_path), size=64, seed=42)
    image = {}
    assert thls.load_hls_product_v2(sorted(files), image, {}, {}, {}, False)
    got = host_budget.realistic_layers(image, torch.device('cpu'))
    t = HlsThresholds()
    bands = [np.clip(np.asarray(image[k], np.int64), 1, None)
             for k in host_budget.BANDS]
    want = oracle.full_chain(*bands, image['fmask'],
                             image['invalid_ind_array'],
                             {k: getattr(t, k)
                              for k in t.__dataclass_fields__})
    assert sorted(got) == sorted(want)
    for name, layer in want.items():
        np.testing.assert_array_equal(got[name], layer, err_msg=name)
    assert len(np.unique(got['WTR'])) > 2


# ---- bench_batch ------------------------------------------------------------

BATCH_SIZE = 64


@pytest.fixture(scope='module')
def batch_lines():
    """The twin's JSON lines at B = 1, 2 for int16 and scaled bands."""
    out = {}
    for mode in ('int', 'scaled'):
        with at_repo_root(), \
                contextlib.redirect_stdout(io.StringIO()) as text:
            assert bench_batch.main(
                ['--device', 'cpu', '--size', str(BATCH_SIZE), '--iters',
                 '1', '--passes', '2', '--batches', '1', '2']
                + (['--scaled'] if mode == 'scaled' else [])) == 0
        out[mode] = _json_lines(text.getvalue())
    return out


def _jax_checksums(scaled, batches):
    """The JAX tool's checksum of one evaluation for each B: its inputs
    (tools/bench_batch.py:57-78, one rng for all B), its cast and its
    kernel (``make_wtr_kernel(..., minimal_outputs=True)``) in interpret
    mode, its int32 sums (:93-96)."""
    H = W = BATCH_SIZE
    rng = np.random.default_rng(0)
    kernel = jax.jit(make_wtr_kernel(JaxConfig(), minimal_outputs=True,
                                     interpret=True, float_inputs=scaled))
    sums = []
    for B in batches:
        bands = [np.clip(rng.integers(-2000, 15000, (B, H, W)), 1,
                         None).astype(np.int16) for _ in range(6)]
        fmask = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
        invalid = (rng.random((B, H, W)) < 0.02).astype(np.uint8)
        six = [jnp.asarray(b) for b in bands]
        if scaled:
            scales = jnp.full((B, 6), 1e-4, jnp.float32)
            offsets = jnp.zeros((B, 6), jnp.float32)
            six = [scales[:, j, None, None]
                   * (x.astype(jnp.float32) - offsets[:, j, None, None])
                   for j, x in enumerate(six)]
        acc = jnp.int32(0)
        for i in range(B):
            out = kernel(*[a[i] for a in six], fmask[i], invalid[i])
            acc = acc + jnp.sum(out['PACKED_A'].astype(jnp.int32)) \
                + jnp.sum(out['PACKED_B'].astype(jnp.int32))
        sums.append(int(acc))
    return sums


@pytest.mark.parametrize('mode', ['int', 'scaled'])
def test_bench_batch_checksums_match_the_jax_kernel(batch_lines, mode):
    lines = batch_lines[mode]
    points = [ln for ln in lines if ln.get('metric')
              == 'batched_device_s_per_tile']
    assert [p['tiles_per_dispatch'] for p in points] == [1, 2]
    assert all(p['scaled'] is (mode == 'scaled') and p['device'] == 'cpu'
               and len(p['pass_s_per_tile']) == 2 and p['s_per_tile'] > 0
               for p in points)
    assert lines[-1] == {'artifact': None}
    assert [p['checksum'] for p in points] == _jax_checksums(
        mode == 'scaled', [1, 2])


def test_bench_batch_checksum_wraps_as_int32():
    assert bench_batch.int32(2**31) == -2**31
    assert bench_batch.int32(2**32 + 5) == 5
    assert bench_batch.int32(-1) == -1


# ---- campaign_soak and soak_back_to_back ------------------------------------

SOAK_SIZE = 96


def _arrays_and_pngs_equal(want_dir, got_dir):
    """Every product of ``want_dir`` in ``got_dir``: the same arrays (the
    COGs' processing times differ) and the same PNG bytes."""
    want = sorted(glob.glob(os.path.join(want_dir, 'tile_*', '*')))
    got = sorted(glob.glob(os.path.join(got_dir, 'tile_*', '*')))
    assert [os.path.relpath(f, want_dir) for f in want] == \
        [os.path.relpath(f, got_dir) for f in got]
    for wf, gf in zip(want, got):
        if wf.endswith('.tif'):
            with TiffReader(wf) as ra, TiffReader(gf) as rb:
                np.testing.assert_array_equal(rb.read(), ra.read(),
                                              err_msg=gf)
        else:
            with open(wf, 'rb') as a, open(gf, 'rb') as b:
                assert a.read() == b.read(), gf
    return len(want)


def test_campaign_soak_resumes_to_an_uninterrupted_run(tmp_path, capsys):
    """6 tiles: phase A with the fault and the kill after 2 tiles done,
    phase B resumed; the soak passes and its products equal a campaign run
    without fault or kill, file by file."""
    root, out = str(tmp_path / 'soak'), str(tmp_path / 'soak.json')
    with at_repo_root():
        rc = campaign_soak.main(['--device', 'cpu', '--size',
                                 str(SOAK_SIZE), '--tiles', '6',
                                 '--kill-after-done', '2', '--root', root,
                                 '--out', out, '--timeout', '300'])
    line = _json_lines(capsys.readouterr().out)[-1]
    with open(out) as fh:
        report = json.load(fh)
    assert rc == 0 and report['status'] == line['soak'] == 'pass', report
    checks = report['checks']
    assert checks['all_done'] and checks['fault_tile_done']
    assert checks['n_products_validated'] == 6 * 11
    assert checks['per_tile_tif_count'] == [11]
    fault = report['fault']
    assert fault['tile'] == 'tile_03' and fault['done_in_phase'] in 'ab'
    assert fault['attempts'] == fault['failed_reads_phase_a'] \
        + fault['failed_reads_phase_b'] + 1
    assert report['phase_b']['returncode'] == 0
    assert 'stage_seconds' in report['phase_b']['campaign_stats']
    assert isinstance(report['phase_a']['killed_mid_campaign'], bool)

    dirs, anc = campaign_soak.build_dataset(root, 6, SOAK_SIZE)
    whole = str(tmp_path / 'whole')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('PROTEUS_TPU_TORCH_DEVICE', 'cpu')
        mp.setattr(sys, 'stdout', sys.stdout)
        mp.setattr(sys, 'stderr', sys.stderr)
        tcampaign.ANCILLARY_CACHE.clear()
        tcli.main(dirs + ['-o', whole, '--dem', anc['dem_file'],
                          '--landcover', anc['landcover_file'],
                          '--worldcover', anc['worldcover_file'],
                          '--shoreline', anc['shoreline_shapefile'],
                          '--browse'])
        tcampaign.ANCILLARY_CACHE.clear()
    # 10 layers and the browse GeoTIFF and PNG a tile
    assert _arrays_and_pngs_equal(whole, os.path.join(root, 'out')) \
        == 6 * 12


def test_soak_back_to_back_prints_its_ratio(tmp_path, capsys):
    """3 tiles, the int soak then the scaled one, each with its fault on
    the last tile: both pass and the ratio of their phase B times is
    printed."""
    with at_repo_root():
        assert soak_back_to_back.main(
            ['--device', 'cpu', '--size', '64', '--tiles', '3',
             '--kill-after-done', '1', '--timeout', '300', '--root',
             str(tmp_path), '--out', str(tmp_path / 'b2b.json')]) == 0
    lines = _json_lines(capsys.readouterr().out)
    summary = lines[-1]
    assert [ln['soak'] for ln in lines[:-1]] == ['pass', 'pass']
    assert summary['metric'] == 'soak_phase_b_scaled_over_int'
    assert [r['mode'] for r in summary['runs']] == ['int', 'scaled']
    assert all(r['status'] == 'pass' and r['fault']['tile'] == 'tile_02'
               for r in summary['runs'])
    assert summary['phase_b_scaled_over_int'] == pytest.approx(
        summary['runs'][1]['phase_b_s'] / summary['runs'][0]['phase_b_s'])
    with open(tmp_path / 'b2b.json') as fh:
        assert json.load(fh)['phase_b_scaled_over_int'] == \
            summary['phase_b_scaled_over_int']


@pytest.mark.parametrize('rc,writes,match', [
    (1, True, 'refusing to read'), (0, False, 'stale or missing')])
def test_soak_back_to_back_refuses_a_failed_or_stale_report(
        tmp_path, monkeypatch, rc, writes, match):
    """A soak that failed, or left only an earlier session's report, is
    never read back."""
    stale = tmp_path / 'soak_int.json'
    stale.write_text('{}')
    os.utime(stale, (0, 0))

    def fake_main(argv):
        if writes:
            stale.write_text('{}')
        return rc
    monkeypatch.setattr(campaign_soak, 'main', fake_main)
    with pytest.raises(RuntimeError, match=match):
        soak_back_to_back.main(['--root', str(tmp_path), '--device', 'cpu'])


def test_campaign_soak_refuses_an_unknown_fault_tile(tmp_path):
    with pytest.raises(ValueError, match='none of the 2 tiles'):
        campaign_soak.main(['--tiles', '2', '--fault-tile', 'tile_07',
                            '--root', str(tmp_path), '--device', 'cpu'])
