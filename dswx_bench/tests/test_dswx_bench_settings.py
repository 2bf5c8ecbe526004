"""A configuration's science settings reach the program and the reference
alike, a mix's grids are data alone, and a setting that either side cannot
take stops the run before its set-up."""

import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, tiny
from dswx_bench import generate, run
from dswx_bench.reference import compare, products


def _other_settings(config):
    """``config`` with settings that differ from the program's defaults in
    every group the chain reads."""
    p = config['processing']
    p['mask_adjacent_to_cloud_mode'] = 'cover'
    p['apply_aerosol_class_remapping'] = False
    p['forest_mask_landcover_classes'] = [20, 111]
    p['min_slope_angle'] = -2
    p['max_sun_local_inc_angle'] = 50
    p['hls_thresholds'].update(wigt=0.05, pswt_1_nir=1800, lcmask_nir=900)
    p['exclude_psw_aggressive_in_browse'] = False
    p['cloud_in_browse'] = 'nodata'
    return config


def test_other_settings_change_the_reference(tmp_path):
    """The settings of ``_other_settings`` change the reference's layers on
    the tiny inputs, so a side that ran the defaults would differ."""
    config, mix = tiny('campaign_timeseries', size=96, acquisitions=1)
    other = _other_settings(copy.deepcopy(config))
    inputs = generate.make_inputs(config, mix, 5, str(tmp_path), 'cpu',
                                  write=False)
    a = inputs.acquisitions[0]
    want = products.product(a, products.grid_layers(
        inputs, a.grid, config['processing']), config['processing'])
    got = products.product(a, products.grid_layers(
        inputs, a.grid, other['processing']), other['processing'])
    changed = {k for k in compare.LIMITS if k in want
               and compare.differing(got[k], want[k])}
    assert {'WTR', 'WTR-2', 'SHAD', 'BROWSE'} <= changed, changed


@pytest.mark.parametrize('workload', ['campaign_timeseries',
                                      'sas_single_tile'])
def test_other_settings_reach_the_program(work, workload):
    config, mix = tiny(workload, size=96,
                       acquisitions=2 if workload.startswith('campaign')
                       else None)
    _other_settings(config)
    mix['sample_products'] = 99
    result, _ = run.run_cell(workload, 2024, 0.3, False, 'cpu',
                             config=config, mix=mix, work=work)
    assert result['correct'], result['checks']


def test_a_mix_of_distinct_grids_is_data_alone(tmp_path):
    """A mix that puts each acquisition of one date on a grid of its own,
    added as a traffic file and a cell in a copy of the benchmark, with no
    other change, runs and is correct."""
    shutil.copytree(os.path.join(ROOT, 'dswx_bench'),
                    tmp_path / 'dswx_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    os.symlink(os.path.join(ROOT, 'proteus_tpu_torch'),
               tmp_path / 'proteus_tpu_torch')
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fh:
        bench = json.load(fh)
    bench['workloads'].append({
        'name': 'campaign_grids', 'config': 'hls_campaign_s30',
        'traffic': 'grids', 'chips': 1, 'why': 'distinct grids, one date'})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    with open(os.path.join(ROOT, 'dswx_bench', 'traffic',
                           'timeseries.json')) as fh:
        mix = json.load(fh)
    mix.update(name='grids', acquisitions=3, revisit_days=0,
               warmup_products=1,
               grid_offsets_px=[[0, 0], [37, -11], [-20, 45]])
    (tmp_path / 'dswx_bench' / 'traffic' / 'grids.json').write_text(
        json.dumps(mix))
    code = f"""
import json, sys
sys.path.insert(0, {str(tmp_path / 'dswx_bench' / 'tests')!r})
from conftest import tiny
from dswx_bench import registry, run
config = tiny('campaign_timeseries', size=64)[0]
mix = registry.traffic('grids')
mix['sample_products'] = 99
result, _ = run.run_cell('campaign_grids', 77, 0.3, False, 'cpu',
                         config=config, mix=mix, work='work')
print(json.dumps([result['correct'], result['attempted'],
                  result['checks']['failed_tiles']['value']]))
"""
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])[0] is True


def test_each_acquisition_on_its_grid():
    config, mix = tiny('campaign_timeseries', size=64, acquisitions=3)
    mix['grid_offsets_px'] = [[0, 0], [10, -4]]
    gts = [g['geotransform'] for g in generate.grids(config['tile'], mix)]
    x0, y0 = config['tile']['x0'], config['tile']['y0']
    assert [(g[0], g[3]) for g in gts] == [(x0, y0), (x0 + 300, y0 + 120),
                                           (x0, y0)]
    one = generate.latlon_bounds(config['tile'], 0.0)
    both = generate.latlon_bounds(generate.grids(config['tile'], mix), 0.0)
    assert both[3] > one[3] and both[1] > one[1]


@pytest.mark.parametrize('key,value', [
    ('apply_ocean_masking', True),
    ('shadow_masking_algorithm', 'otsu'),
    ('scaled_inputs', True)])
def test_what_the_reference_cannot_check_stops_the_run(work, key, value):
    config, mix = tiny('campaign_timeseries', size=64, acquisitions=1)
    group = 'campaign' if key == 'scaled_inputs' else 'processing'
    config[group][key] = value
    with pytest.raises(NotImplementedError):
        run.run_cell('campaign_timeseries', 1, 0.1, False, 'cpu',
                     config=config, mix=mix, work=work)
    assert not os.path.exists(os.path.join(work, 'run', 'inputs'))


@pytest.mark.parametrize('workload,key,value', [
    ('campaign_timeseries', 'browse_height', 512),
    ('campaign_timeseries', 'landcover_mask_type', 'water heavy'),
    ('sas_single_tile', 'dem_margin_px', 20)])
def test_what_the_program_fixes_is_refused(work, workload, key, value):
    config, mix = tiny(workload, size=64, acquisitions=1)
    config['processing'][key] = value
    with pytest.raises(ValueError, match=key):
        run.run_cell(workload, 1, 0.1, False, 'cpu', config=config, mix=mix,
                     work=work)


def test_the_runconfig_holds_every_setting(tmp_path):
    """The SAS's runconfig, read back by the program's own parser, states
    the configuration's settings."""
    from proteus_tpu_torch.config.runconfig import parse_runconfig_file
    config, _ = tiny('sas_single_tile')
    p = _other_settings(config)['processing']
    anc = {k: (str(tmp_path / f'{k}.tif'),) for k in
           ('dem', 'cgls', 'worldcover')}
    path = generate.write_runconfig(str(tmp_path / 'rc.yaml'),
                                    str(tmp_path), str(tmp_path / 'out'),
                                    str(tmp_path / 's'), anc, p)

    class Args:
        pass
    args = Args()
    consts = parse_runconfig_file(user_runconfig_file=path, args=args)
    assert args.mask_adjacent_to_cloud_mode == 'cover'
    assert args.apply_aerosol_class_remapping is False
    assert list(args.forest_mask_landcover_classes) == [20, 111]
    assert args.max_sun_local_inc_angle == 50
    assert args.cloud_in_browse == 'nodata'
    assert args.exclude_psw_aggressive_in_browse is False
    assert np.isclose(consts.hls_thresholds.wigt, 0.05)
    assert consts.hls_thresholds.lcmask_nir == 900
    key = ('aerosol_partial_surface_water_conservative_to_high_conf_water'
           '_fmask_values')
    assert list(getattr(args, key)) == p['aerosol_lists']['3']
