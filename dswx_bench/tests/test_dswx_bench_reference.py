"""The plain reference against the port on the CPU at small sizes, through
whole runs of the harness, and the run's process free of JAX and of the
JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, tiny
from dswx_bench import generate, run
from dswx_bench.reference import compare, products


@pytest.mark.parametrize('workload,size', [('campaign_timeseries', 64),
                                           ('campaign_timeseries', 97),
                                           ('sas_single_tile', 80)])
def test_the_port_is_the_reference(work, workload, size):
    config, mix = tiny(workload, size=size, acquisitions=3
                       if workload.startswith('campaign') else None)
    mix['sample_products'] = 99
    result, _ = run.run_cell(workload, 987654321987 + size, 1.0, False,
                             'cpu', config=config, mix=mix, work=work)
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] >= 2


def test_the_reference_has_every_class(tmp_path):
    """The sampled layers are no trivial images: both SHAD values, water,
    cloud and snow in WTR, and several LAND classes."""
    config, mix = tiny('campaign_timeseries', size=128, acquisitions=1)
    inputs = generate.make_inputs(config, mix, 11, str(tmp_path), 'cpu',
                                  write=False)
    p = config['processing']
    layers = products.product(inputs.acquisitions[0],
                              products.grid_layers(inputs, inputs.grid, p), p)
    assert set(np.unique(layers['SHAD'])) == {0, 1}
    assert {0, 1, 252, 253, 255} <= set(np.unique(layers['WTR']))
    assert len(np.unique(layers['LAND'])) >= 4
    assert np.isfinite(layers['DEM']).all()


def test_differing_counts_pixels():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    b = a.copy()
    b[1, 1] = np.nextafter(b[1, 1], np.float32(100))
    assert compare.differing(b, a) == 1
    assert compare.differing(None, a) == 12
    assert compare.differing(a[:2], a) == 12
    nan = np.full(3, np.nan, np.float32)
    assert compare.differing(nan.copy(), nan) == 0


def test_no_jax_in_the_run(tmp_path):
    """A whole small run in a fresh process leaves no top-level ``jax``,
    ``jaxlib``, ``flax`` or ``proteus_tpu`` in ``sys.modules``."""
    code = f"""
import json, sys
sys.path.insert(0, {os.path.join(ROOT, 'dswx_bench', 'tests')!r})
from conftest import tiny
from dswx_bench import run
config, mix = tiny('sas_single_tile')
result, _ = run.run_cell('sas_single_tile', 5, 0.2, False, 'cpu',
                         config=config, mix=mix, work={str(tmp_path)!r})
print(json.dumps({{'correct': result['correct'],
                  'found': run.forbidden_modules(),
                  'port': 'proteus_tpu_torch' in sys.modules}}))
"""
    env = dict(os.environ)
    env.pop('JAX_PLATFORMS', None)
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {'correct': True, 'found': [], 'port': True}


def test_forbidden_names_are_whole():
    assert run.forbidden_modules(['proteus_tpu_torch.io.cog', 'jaxtyping',
                                  'numpy', 'flaxen']) == []
    assert run.forbidden_modules(['proteus_tpu.geo.warp', 'jax.numpy',
                                  'jaxlib', 'flax.linen']) == \
        ['flax', 'jax', 'jaxlib', 'proteus_tpu']
