"""Parity of the PyTorch per-pixel chain and the fused kernel's plain
version with proteus_tpu (JAX on the CPU), tolerance 0.

The same numpy inputs, made from a seed, go through each ported module
(diagnostics, interpretation, masking, browse, chain) and its JAX
counterpart; the kernel module's plain version is held against the Pallas
kernel in interpret mode, as tests/test_pallas_kernel.py runs it. Every
layer is an integer array, so equality is exact.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from proteus_tpu.core.thresholds import HlsThresholds
from proteus_tpu.models.dswx import browse as jbrowse
from proteus_tpu.models.dswx import chain as jchain
from proteus_tpu.models.dswx import diagnostics as jdiag
from proteus_tpu.models.dswx import interpretation as jinterp
from proteus_tpu.models.dswx import masking as jmasking
from proteus_tpu.ops.pallas.wtr_kernel import make_wtr_kernel
from proteus_tpu_torch.models.dswx import browse as tbrowse
from proteus_tpu_torch.models.dswx import chain as tchain
from proteus_tpu_torch.models.dswx import diagnostics as tdiag
from proteus_tpu_torch.models.dswx import interpretation as tinterp
from proteus_tpu_torch.models.dswx import masking as tmasking
from proteus_tpu_torch.ops import wtr_kernel

torch.set_num_threads(1)

SHAPE = (64, 128)
LAYERS = ('DIAG', 'WTR-1', 'WTR-2', 'WTR', 'BWTR', 'CONF', 'CLOUD')
BROWSE_OPTIONS = {
    'default': {},
    'nodata': dict(exclude_psw_aggressive_in_browse=False,
                   not_water_in_browse='nodata', cloud_in_browse='nodata',
                   snow_in_browse='nodata'),
}


def make_inputs(seed, shape=SHAPE):
    """int16 bands (10% at the int16 extremes, so the wrap-around of the
    band sums is load-bearing), fmask, invalid and ancillary planes."""
    rng = np.random.default_rng(seed)
    bands = []
    for _ in range(6):
        b = rng.integers(-2000, 18000, shape)
        extreme = rng.random(shape) < 0.1
        b = np.where(extreme, rng.integers(-32768, 32768, shape), b)
        bands.append(b.astype(np.int16))
    return dict(
        bands=bands,
        fmask=rng.integers(0, 256, shape).astype(np.uint8),
        invalid=rng.random(shape) < 0.05,
        ocean=(rng.random(shape) < 0.9).astype(np.uint8),
        shadow=(rng.random(shape) < 0.8).astype(np.uint8),
        landcover=rng.choice(np.array([0, 21, 100, 121, 200, 201, 255],
                                      np.uint8), shape))


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same(got, want, msg=''):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, msg
    np.testing.assert_array_equal(got, want, err_msg=msg)


INPUTS = make_inputs(7)


# ---- diagnostics -------------------------------------------------------

@pytest.mark.parametrize('thresholds', [
    HlsThresholds(),
    HlsThresholds(wigt=-0.05, awgt=-12.25, pswt_1_ndvi=0.35,
                  pswt_2_mndwi=0.1, pswt_1_nir=1234, pswt_2_swir2=-3),
], ids=['default', 'shifted'])
def test_diagnostic_tests(thresholds):
    b = INPUTS['bands']
    want = jdiag.compute_diagnostic_tests(*b, thresholds)
    got = tdiag.compute_diagnostic_tests(*[T(x) for x in b], thresholds)
    assert_same(got, want)
    assert_same(tdiag.get_binary_representation(got),
                jdiag.get_binary_representation(want))


def test_binary_representation_exhaustive():
    d = np.arange(33, dtype=np.int32)
    got = tdiag.get_binary_representation(T(d))
    assert got.dtype == torch.uint16
    assert_same(got, jdiag.get_binary_representation(jnp.asarray(d)))
    assert_same(got, jdiag.binary_representation_lut())


def test_wrap16_matches_int16():
    x = np.arange(-70000, 70000, 7, dtype=np.int32)
    assert_same(tdiag.wrap16(T(x)), x.astype(np.int16).astype(np.int32))


@pytest.mark.parametrize('change', [dict(wigt=0.12345678), dict(awgt=1e-7),
                                    dict(lcmask_nir=0.1 + 0.2)],
                         ids=['wigt', 'awgt', 'lcmask'])
def test_inexact_thresholds_run(change):
    """A threshold with no exact rational runs: the kernels' parameters
    carry it as an integer bound or a float64, and the plain chain decides
    it as the reference does."""
    cfg = tchain.DswxChainConfig(thresholds=HlsThresholds(**change))
    params, bounds, _ = wtr_kernel.kernel_params(cfg)
    assert params.ratio_f64 == int('wigt' in change)
    assert (bounds.awesh4_ge, bounds.lcmask_ge) == (1, 1 if 'lcmask_nir' in
                                                    change else 1201)
    out = wtr_kernel.wtr_layers(*[T(x) for x in INPUTS['bands']],
                                T(INPUTS['fmask']), T(INPUTS['invalid']),
                                cfg, landcover=T(INPUTS['landcover']))
    jcfg = jchain.DswxChainConfig(thresholds=HlsThresholds(**change))
    want = jchain.dswx_chain(*INPUTS['bands'], INPUTS['fmask'],
                             INPUTS['invalid'], jcfg,
                             landcover_mask=INPUTS['landcover'])
    for name in wtr_kernel.LAYERS + ('BROWSE',):
        assert_same(out[name], want[name])


# ---- interpretation ------------------------------------------------------

def test_interpretation_layers():
    d = np.arange(34, dtype=np.int32).reshape(2, 17)
    assert_same(tinterp.generate_interpreted_layer(T(d)),
                jinterp.generate_interpreted_layer(jnp.asarray(d)))
    all_u8 = np.arange(256, dtype=np.uint8).reshape(16, 16)
    assert_same(tinterp.collapse_wtr_classes(T(all_u8)),
                jinterp.collapse_wtr_classes(jnp.asarray(all_u8)))
    assert_same(tinterp.get_binary_water_layer(T(all_u8)),
                jinterp.get_binary_water_layer(jnp.asarray(all_u8)))
    wtr2, cloud = np.meshgrid(np.arange(256, dtype=np.uint8),
                              np.arange(256, dtype=np.uint8))
    assert_same(tinterp.get_confidence_layer(T(wtr2), T(cloud)),
                jinterp.get_confidence_layer(jnp.asarray(wtr2),
                                             jnp.asarray(cloud)))


# ---- masking -------------------------------------------------------------

@pytest.mark.parametrize('mode', ['mask', 'ignore'])
def test_masking_stages(mode):
    rng = np.random.default_rng(3)
    wtr1 = rng.choice(np.array([0, 1, 2, 3, 4, 254, 255], np.uint8), SHAPE)
    nir = INPUTS['bands'][3]
    fmask = INPUTS['fmask']
    lut = jchain.DswxChainConfig().aerosol_lut()
    np.testing.assert_array_equal(
        tchain.DswxChainConfig().aerosol_lut(), lut)

    cloud_j = jmasking.compute_preliminary_cloud_layer(fmask, mode)
    cloud_t = tmasking.compute_preliminary_cloud_layer(T(fmask), mode)
    assert_same(cloud_t, cloud_j)

    wj, cj = jmasking.apply_aerosol_class_remapping(wtr1, nir, cloud_j,
                                                    fmask, lut)
    wt, ct = tmasking.apply_aerosol_class_remapping(T(wtr1), T(nir), cloud_t,
                                                    T(fmask), lut)
    assert_same(wt, wj)
    assert_same(ct, cj)

    for lc, sh in itertools.product((None, INPUTS['landcover']),
                                    (None, INPUTS['shadow'])):
        w2j = jmasking.apply_landcover_and_shadow_masks(
            wj, nir, lc, sh, HlsThresholds())
        w2t = tmasking.apply_landcover_and_shadow_masks(
            wt, T(nir), None if lc is None else T(lc),
            None if sh is None else T(sh), HlsThresholds())
        assert_same(w2t, w2j, f'lc={lc is not None} shadow={sh is not None}')

    c2j = jmasking.add_snow_to_cloud_layer(w2j, cj, fmask, mode)
    c2t = tmasking.add_snow_to_cloud_layer(w2t, ct, T(fmask), mode)
    assert_same(c2t, c2j)
    assert_same(tmasking.apply_cloud_masking(w2t, c2t),
                jmasking.apply_cloud_masking(w2j, c2j))


# ---- browse --------------------------------------------------------------

@pytest.mark.parametrize('flags', list(itertools.product((False, True),
                                                         repeat=5)))
def test_browse(flags):
    collapse, excl, nw, cl, sn = flags
    rng = np.random.default_rng(5)
    wtr = rng.choice(np.array([0, 1, 2, 3, 4, 252, 253, 254, 255], np.uint8),
                     SHAPE)
    kw = dict(flag_collapse_wtr_classes=collapse, exclude_psw_aggressive=excl,
              set_not_water_to_nodata=nw, set_cloud_to_nodata=cl,
              set_snow_to_nodata=sn)
    assert_same(tbrowse.compute_browse_array(T(wtr), **kw),
                jbrowse.compute_browse_array(jnp.asarray(wtr), **kw))


# ---- the chain -----------------------------------------------------------

CHAIN_CASES = list(itertools.product(
    ('mask', 'ignore'), itertools.product((False, True), repeat=3),
    (True, False), tuple(BROWSE_OPTIONS)))


def _case_id(case):
    mode, (oc, sh, lc), aerosol, browse = case
    return (f'{mode}-ocean{int(oc)}-shadow{int(sh)}-lc{int(lc)}'
            f'-aerosol{int(aerosol)}-{browse}')


def _configs(mode, aerosol, browse):
    kw = dict(mask_adjacent_to_cloud_mode=mode,
              apply_aerosol_class_remapping=aerosol,
              **BROWSE_OPTIONS[browse])
    jcfg = jchain.DswxChainConfig(**kw)
    return jcfg, tchain.DswxChainConfig.from_reference(jcfg)


@pytest.mark.parametrize('case', CHAIN_CASES, ids=map(_case_id, CHAIN_CASES))
def test_chain_matches_jax(case):
    mode, (with_ocean, with_shadow, with_lc), aerosol, browse = case
    jcfg, tcfg = _configs(mode, aerosol, browse)
    inp = make_inputs(11)
    extras = {'ocean_mask': inp['ocean'] if with_ocean else None,
              'shadow_layer': inp['shadow'] if with_shadow else None,
              'landcover_mask': inp['landcover'] if with_lc else None}
    want = jchain.dswx_chain(*inp['bands'], inp['fmask'], inp['invalid'],
                             jcfg, **extras)
    got = tchain.dswx_chain(*[T(b) for b in inp['bands']], T(inp['fmask']),
                            T(inp['invalid']), tcfg,
                            **{k: None if v is None else T(v)
                               for k, v in extras.items()})
    assert sorted(got) == sorted(want)
    assert got['DIAG'].dtype == torch.uint16
    for name in want:
        if name.startswith('n_'):
            assert int(got[name]) == int(want[name]), name
        else:
            assert got[name].dtype == torch.uint8 or name == 'DIAG', name
            assert_same(got[name], want[name], name)


def test_config_from_reference_copies_every_field():
    jcfg = jchain.DswxChainConfig(
        thresholds=HlsThresholds(wigt=0.2), mask_adjacent_to_cloud_mode='ignore',
        aerosol_not_water_fmask_values=(1, 2), snow_in_browse='nodata',
        min_slope_angle=-3.0)
    tcfg = tchain.DswxChainConfig.from_reference(jcfg)
    import dataclasses
    assert [f.name for f in dataclasses.fields(tcfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(jcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


# ---- the kernel module ---------------------------------------------------

KERNEL_CASES = list(itertools.product(('mask', 'ignore'), (True, False),
                                      (True, False)))


@pytest.mark.parametrize('mode,with_ancillaries,browse', KERNEL_CASES)
def test_kernel_plain_matches_pallas_interpret(mode, with_ancillaries,
                                               browse):
    jcfg, tcfg = _configs(mode, True,
                          'nodata' if with_ancillaries else 'default')
    inp = make_inputs(21)
    extras = ('ocean', 'shadow', 'landcover') if with_ancillaries else ()
    kernel = make_wtr_kernel(jcfg, with_ocean=with_ancillaries,
                             with_shadow=with_ancillaries,
                             with_landcover=with_ancillaries,
                             compute_browse=browse, block_rows=32,
                             interpret=True)
    want = kernel(*[jnp.asarray(b) for b in inp['bands']],
                  jnp.asarray(inp['fmask']), jnp.asarray(inp['invalid']),
                  *[jnp.asarray(inp[k]) for k in extras])
    # CPU tensors: the wrapper runs the plain version
    got = wtr_kernel.wtr_layers(*[T(b) for b in inp['bands']],
                                T(inp['fmask']), T(inp['invalid']), tcfg,
                                compute_browse=browse,
                                **{k: T(inp[k]) for k in extras})
    assert sorted(got) == sorted([*want, *wtr_kernel.COUNTS])
    for name in want:
        assert_same(got[name], want[name], name)


def test_cpu_tensors_never_launch_the_kernel():
    before = dict(wtr_kernel.LAUNCHES)
    assert sorted(before) == [f'wtr_k{k}' for k in range(1, 7)] \
        + ['wtr_k6_spatial']
    for bands, mode in itertools.product(
            (INPUTS['bands'], [b.astype(np.float32) * np.float32(1e-4)
                               for b in INPUTS['bands']]),
            ('mask', 'cover')):
        cfg = tchain.DswxChainConfig(mask_adjacent_to_cloud_mode=mode)
        out = wtr_kernel.wtr_layers(
            *[T(b) for b in bands], T(INPUTS['fmask']), T(INPUTS['invalid']),
            cfg)
        assert sorted(out) == sorted(LAYERS + ('BROWSE',)
                                     + wtr_kernel.COUNTS)
        out = wtr_kernel.wtr_layers_batched(
            *[T(b[None]) for b in bands], T(INPUTS['fmask'][None]),
            T(INPUTS['invalid'][None]), cfg, minimal=True)
        assert sorted(out) == sorted(wtr_kernel.PACKED + wtr_kernel.COUNTS)
        out = wtr_kernel.wtr_layers_batched(
            *[T(b[None]) for b in bands], T(INPUTS['fmask'][None]),
            T(INPUTS['invalid'][None]), cfg, window=(1, 2))
        assert out['WTR'].shape[1] == 2
    assert wtr_kernel.LAUNCHES == before


def test_kernel_params_layout():
    """The by-value structs handed to the kernels carry the ratio tests'
    (p, q) pairs of ExactThresholds, the other tests' integer bounds and
    the aerosol LUT (int16 bands), or each threshold as NumPy's float32 and
    the LUT (float32 bands)."""
    import ctypes
    from proteus_tpu.core.thresholds import ExactThresholds
    cfg = tchain.DswxChainConfig(
        thresholds=HlsThresholds(wigt=0.2, pswt_2_swir2=-3),
        aerosol_psw_aggressive_fmask_values=(7,))
    params, bounds, _ = wtr_kernel.kernel_params(cfg)
    assert ctypes.sizeof(params) == 4 * 8 + 9 * 4 + 256 + 4  # 8-aligned
    assert ctypes.sizeof(bounds) == 8 * 4
    et = ExactThresholds.from_thresholds(cfg.thresholds)
    assert (params.wigt_p, params.wigt_q) == et.wigt[:2] == (1, 5)
    assert (params.ratio_f64, params.wigt_t) == (0, 0.2)
    # band < -3 is band <= -4; nir > 1200 is nir >= 1201
    assert (bounds.p2_swir2_le, bounds.lcmask_ge) == (-4, 1201)
    np.testing.assert_array_equal(np.array(params.aerosol_lut),
                                  cfg.aerosol_lut())
    assert params.aerosol_lut[7] == 8

    # float32 bands: thresholds that are not exact rationals are fine
    cfg = tchain.DswxChainConfig(
        thresholds=HlsThresholds(wigt=0.12345678, pswt_1_ndvi=1 / 3,
                                 lcmask_nir=0.1 + 0.2),
        aerosol_psw_aggressive_fmask_values=(7,))
    params, _, params_f32 = wtr_kernel.kernel_params(cfg, float_bands=True)
    assert ctypes.sizeof(params_f32) == 12 * 4
    t = cfg.thresholds
    for name, field in (('wigt', 'wigt'), ('awgt', 'awgt'),
                        ('p1_ndvi', 'pswt_1_ndvi'),
                        ('p2_swir2', 'pswt_2_swir2'),
                        ('lcmask', 'lcmask_nir')):
        assert np.float32(getattr(params_f32, name)) == \
            np.float32(getattr(t, field)), name
    assert (params.wigt_p, params.wigt_q) == (0, 0)
    assert params.aerosol_lut[7] == 8
    flags = wtr_kernel.kernel_flags(
        tchain.DswxChainConfig(mask_adjacent_to_cloud_mode='cover'),
        True, False, True, True)
    assert ctypes.sizeof(flags) == 14 * 4
    assert (flags.minimal, flags.ocean_in_valid) == (0, 1)
    assert (flags.cover, flags.mask_adjacent, flags.with_ocean,
            flags.with_shadow) == (1, 0, 1, 0)
