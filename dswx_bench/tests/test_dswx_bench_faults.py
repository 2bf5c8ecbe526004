"""The comparison is not blind: the rest of a run, with the timed path
broken underneath, comes out not correct, and so does the control, the
reference at the precision below the science's.

The faults these cells can have: an answer altered where it is produced
(a pixel of the per-pixel kernel's output, in the campaign's batched step
and in the SAS's launch), and half of a batch left out (the second tile
of each device's share given the first tile's layers). The cells have no
state a step carries (a step that returns its state unchanged) and no
exchange between chips.
"""

import numpy as np
import pytest

from conftest import tiny
from dswx_bench import control, run


def _run(workload, work, acquisitions=None):
    config, mix = tiny(workload, size=64, acquisitions=acquisitions)
    mix['sample_products'] = 99
    result, _ = run.run_cell(workload, 424242424242, 0.3, False, 'cpu',
                             config=config, mix=mix, work=work)
    return result


def _flip_a_pixel(out):
    wtr = out['WTR']
    wtr[..., 20, 30] = wtr[..., 20, 30] ^ 1
    return out


def test_a_campaign_pixel_altered(work, monkeypatch):
    from proteus_tpu_torch.parallel import campaign
    batched = campaign.wtr_layers_batched
    monkeypatch.setattr(campaign, 'wtr_layers_batched',
                        lambda *a, **k: _flip_a_pixel(batched(*a, **k)))
    result = _run('campaign_timeseries', work, acquisitions=2)
    assert not result['correct']
    assert result['checks']['WTR']['value'] == 1


def test_half_of_the_batch_left_out(work, monkeypatch):
    from proteus_tpu_torch.parallel import campaign
    batched = campaign.wtr_layers_batched

    def first_half(*args, **kwargs):
        out = batched(*args, **kwargs)
        for name, t in out.items():
            if t.dim() == 3 and t.shape[0] > 1:
                t[t.shape[0] // 2:] = t[:t.shape[0] // 2]
        return out

    monkeypatch.setattr(campaign, 'wtr_layers_batched', first_half)
    result = _run('campaign_timeseries', work, acquisitions=2)
    assert not result['correct']
    assert result['checks']['WTR-1']['value'] > 0


def test_a_sas_pixel_altered(work, monkeypatch):
    from proteus_tpu_torch.runtime import orchestrator
    layers = orchestrator.wtr_layers
    monkeypatch.setattr(orchestrator, 'wtr_layers',
                        lambda *a, **k: _flip_a_pixel(layers(*a, **k)))
    result = _run('sas_single_tile', work)
    assert not result['correct']
    assert result['checks']['WTR']['value'] == 1


def test_unbroken_runs_are_correct(work):
    assert _run('sas_single_tile', work)['correct']


@pytest.mark.parametrize('workload', ['campaign_timeseries',
                                      'sas_single_tile'])
def test_the_control_fails(workload):
    config, mix = tiny(workload, size=96, acquisitions=2)
    r = control.readings(config, mix, 31, 'cpu')
    assert r['DEM'] > 0
    assert set(r) == set(control.compare.LIMITS) - {'failed_tiles'}


@pytest.mark.card
def test_a_run_on_the_card(work):
    """A small run of each cell on the card, where there is one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card: the kernels run only on the card')
    for workload in ('campaign_timeseries', 'sas_single_tile'):
        config, mix = tiny(workload, size=512, acquisitions=2)
        result, _ = run.run_cell(workload, 7, 1.0, False, 'cuda',
                                 config=config, mix=mix, work=work)
        assert result['correct'], result['checks']
        assert np.isfinite(result['device']['memory_peak_bytes'])
