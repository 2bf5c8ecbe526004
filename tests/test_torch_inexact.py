"""Integer-band thresholds that are no exact rationals: the port against
proteus_tpu (JAX on the CPU) and the numpy float64 oracle, tolerance 0, and
the parameters that carry such thresholds to the CUDA kernels.

The int16 bands are pushed onto the decision boundaries: ratio operands
whose float64 quotient is the exact rational next to the threshold (so the
division's rounding decides), band values on both sides of every scalar
threshold, AWEsh on both sides of its bound, and zero denominators. Every
layer is an integer array, so equality is exact.
"""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import oracle
import synthetic
from proteus_tpu.core.thresholds import HlsThresholds
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.models.dswx import chain as jchain
from proteus_tpu.models.dswx import diagnostics as jdiag
from proteus_tpu.models.dswx import masking as jmasking
from proteus_tpu.parallel import campaign as jcampaign
from proteus_tpu.runtime.orchestrator import \
    generate_dswx_layers as jax_generate
from proteus_tpu_torch.core import f32exact
from proteus_tpu_torch.core.thresholds import ExactThresholds
from proteus_tpu_torch.models.dswx import chain as tchain
from proteus_tpu_torch.models.dswx import diagnostics as tdiag
from proteus_tpu_torch.models.dswx import masking as tmasking
from proteus_tpu_torch.ops import wtr_kernel
from proteus_tpu_torch.parallel import campaign as tcampaign
from proteus_tpu_torch.runtime.compare import compare_dswx_hls_products
from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers
from test_torch_chain import T, assert_same, make_inputs
from test_torch_e2e import LAYERS, _inputs, _outputs

torch.set_num_threads(1)

SHAPE = (96, 128)
FIELDS = tuple(f.name for f in dataclasses.fields(HlsThresholds))
RATIO_FIELDS = (('wigt', 'mndwi'), ('pswt_1_mndwi', 'mndwi'),
                ('pswt_2_mndwi', 'mndwi'), ('pswt_1_ndvi', 'ndvi'))
# the band (its index in blue, green, red, nir, swir1, swir2) of each
# scalar threshold
SCALAR_FIELDS = (('pswt_1_swir1', 4), ('pswt_1_nir', 3), ('pswt_2_blue', 0),
                 ('pswt_2_swir1', 4), ('pswt_2_swir2', 5), ('pswt_2_nir', 3),
                 ('lcmask_nir', 3))


def _up(v):
    return float(np.nextafter(v, np.inf))


def _down(v):
    return float(np.nextafter(v, -np.inf))


THRESHOLDS = {
    # the float64 next to an exact rational: a quotient that is that
    # rational lies one ULP from the threshold
    'next_to_rational': HlsThresholds(
        wigt=_up(1 / 3), awgt=_down(0.25), pswt_1_mndwi=_down(-1 / 3),
        pswt_1_nir=_up(1500.0), pswt_1_swir1=_down(900.0),
        pswt_1_ndvi=_down(2 / 3), pswt_2_mndwi=_up(-0.5),
        pswt_2_blue=_up(1000.0), pswt_2_nir=_down(2500.0),
        pswt_2_swir1=_up(3000.0), pswt_2_swir2=_down(1000.0),
        lcmask_nir=_up(1200.0)),
    'irrational': HlsThresholds(
        wigt=np.pi / 25, awgt=np.e / 10, pswt_1_mndwi=-np.sqrt(2) / 3,
        pswt_1_nir=1000 * np.pi / 2, pswt_1_swir1=900 + np.e / 7,
        pswt_1_ndvi=np.pi / 4.5, pswt_2_mndwi=-np.e / 5,
        pswt_2_blue=3000 / np.pi, pswt_2_nir=2500.5 - np.pi / 1e3,
        pswt_2_swir1=3000 * np.sqrt(0.99), pswt_2_swir2=1000 + 1 / np.e,
        lcmask_nir=1200 + np.pi / 10),
    # one inexact field: the exact and the inexact branches side by side
    'one_field': HlsThresholds(pswt_1_ndvi=0.700000001),
}
# thresholds whose integer bound is None (the test is all-false) or beyond
# int32 (all-true after the clip)
NONE_BOUNDS = {
    'nan': {k: float('nan') for k in FIELDS},
    'plus_inf': {k: float('inf') for k in FIELDS},
    'minus_inf': {k: float('-inf') for k in FIELDS},
    'mixed': dict(awgt=float('inf'), pswt_1_nir=float('-inf'),
                  pswt_2_blue=float('inf'), lcmask_nir=float('nan'),
                  wigt=float('-inf')),
}
# thresholds outside the JAX package's exact-boundary domain, where it
# falls back to a float32 division it calls approximate; the port keeps the
# float64 division, NumPy's decision
DEGENERATE = {
    'tiny': dict(wigt=1e-35, pswt_1_mndwi=-1e-38, pswt_1_ndvi=3e-33,
                 pswt_2_mndwi=1e-31),
    'beyond_float32': dict(wigt=1e39, pswt_1_mndwi=-1e39, pswt_1_ndvi=1e39,
                           pswt_2_mndwi=-2e38 * 2),
}


def _values(t):
    return {k: getattr(t, k) for k in FIELDS}


def _split(total, parity_of):
    """(a, b) with a + b == total and a - b as near to ``parity_of`` as the
    parity of ``total`` allows."""
    diff = parity_of + ((total + parity_of) & 1)
    return (total + diff) // 2, (total - diff) // 2


def boundary_bands(seed, shape, t):
    """int16 bands with a share of the pixels on each decision boundary of
    the thresholds ``t``; the rest as ``make_inputs`` draws them."""
    rng = np.random.default_rng(seed)
    bands = [b.astype(np.int64) for b in make_inputs(seed, shape)['bands']]
    kind = rng.integers(0, 10, shape)
    jitter = rng.integers(-1, 3, shape)

    # ratio tests: num = floor(t * den) + jitter; mndwi from (green, swir1),
    # ndvi from (nir, red). Denominators that are multiples of 30 make
    # quotients of small rationals (1/3, -1/2, 2/3, 7/10) exact.
    den = 30 * rng.integers(1, 400, shape)
    for k, (field, ratio) in enumerate(RATIO_FIELDS):
        tval = getattr(t, field)
        if not np.isfinite(tval) or abs(tval) > 1:
            continue
        num = np.floor(tval * den).astype(np.int64) + jitter
        a, b = _split(den, num)
        hi, lo = (1, 4) if ratio == 'mndwi' else (3, 2)
        sel = kind == k
        bands[hi] = np.where(sel, a, bands[hi])
        bands[lo] = np.where(sel, b, bands[lo])
    # zero denominators: x/0 and 0/0
    sel = kind == 4
    bands[4] = np.where(sel, -bands[1], bands[4])
    bands[2] = np.where(sel, -bands[3], bands[2])
    bands[1] = np.where(sel & (jitter == 0), 0, bands[1])
    bands[4] = np.where(sel & (jitter == 0), 0, bands[4])
    # scalar thresholds: the band on floor(t) - 1 .. floor(t) + 2
    which = rng.integers(0, len(SCALAR_FIELDS), shape)
    for k, (field, band) in enumerate(SCALAR_FIELDS):
        tval = getattr(t, field)
        if not np.isfinite(tval):
            continue
        sel = (kind == 5) & (which == k)
        bands[band] = np.where(sel, int(np.floor(tval)) + jitter,
                               bands[band])
    bands = [np.clip(b, -32768, 32767).astype(np.int16) for b in bands]
    # AWEsh: swir2 puts awesh4 = 4 b + 10 g - 6 wrap16(n + s1) - s2 on
    # floor(4 t) - 1 .. floor(4 t) + 2 where that fits an int16
    if np.isfinite(t.awgt):
        b, g, n, s1 = (bands[k].astype(np.int64) for k in (0, 1, 3, 4))
        mbsrn = (bands[3] + bands[4]).astype(np.int64)  # wraps in int16
        s2 = 4 * b + 10 * g - 6 * mbsrn - (int(np.floor(4 * t.awgt))
                                           + jitter)
        sel = ((kind == 6) | (kind == 7)) & (np.abs(s2) < 32768)
        bands[5] = np.where(sel, s2, bands[5]).astype(np.int16)
    return bands


def _oracle_tests(bands, t):
    with np.errstate(divide='ignore', invalid='ignore'):
        return oracle.diagnostic_tests(*bands, _values(t))


# ---- the inputs ----------------------------------------------------------

@pytest.mark.parametrize('name', list(THRESHOLDS))
def test_thresholds_are_inexact_and_inputs_sit_on_the_boundaries(name):
    t = THRESHOLDS[name]
    exact = ExactThresholds.from_thresholds(t)
    changed = [k for k in FIELDS if getattr(t, k) != getattr(HlsThresholds(),
                                                             k)]
    assert changed
    for k in changed:
        assert getattr(exact, k)[2] is False, k
    blue, green, red, nir, swir1, swir2 = (
        b.astype(np.float64) for b in boundary_bands(5, SHAPE, t))
    with np.errstate(divide='ignore', invalid='ignore'):
        ratios = {'mndwi': (green - swir1) / (green + swir1),
                  'ndvi': (nir - red) / (nir + red)}
    for field, ratio in RATIO_FIELDS:
        q, tval = ratios[ratio], getattr(t, field)
        # both sides of the threshold, closer than any default-path pixel
        assert ((q > tval) & (q - tval < 1e-3)).any(), field
        assert ((q < tval) & (tval - q < 1e-3)).any(), field
    if name == 'next_to_rational':
        assert (ratios['mndwi'] == 1 / 3).any()   # one ULP under wigt
        assert (ratios['mndwi'] == -0.5).any()
        assert (ratios['ndvi'] == 2 / 3).any()
    assert np.isnan(ratios['mndwi']).any()
    assert np.isinf(ratios['mndwi']).any() and np.isinf(ratios['ndvi']).any()
    for field, band in SCALAR_FIELDS:
        values = (blue, green, red, nir, swir1, swir2)[band]
        floor = np.floor(getattr(t, field))
        assert (values == floor).any() and (values == floor + 1).any(), field


# ---- the host bounds -----------------------------------------------------

@pytest.mark.parametrize('t', [0.0, -0.0, 0.5, -0.5, 3.0, -3.0, 1 / 3,
                               1500.314159, -2 ** 40 + 0.5, float('inf'),
                               float('-inf'), float('nan')])
def test_int_bounds_match_the_reference_and_the_definition(t):
    from proteus_tpu.core import f32exact as jf32exact
    gt, lt = f32exact.int_gt_bound(t), f32exact.int_lt_bound(t)
    assert gt == jf32exact.int_gt_bound(t)
    assert lt == jf32exact.int_lt_bound(t)
    ints = np.arange(-5000, 5000).astype(np.float64)
    with np.errstate(invalid='ignore'):
        want_gt, want_lt = ints > t, ints < t
    np.testing.assert_array_equal(
        want_gt, np.zeros(ints.shape, bool) if gt is None else ints >= gt)
    np.testing.assert_array_equal(
        want_lt, np.zeros(ints.shape, bool) if lt is None else ints <= lt)


# ---- diagnostics -----------------------------------------------------------

@pytest.mark.parametrize('name', list(THRESHOLDS))
def test_diagnostic_tests_inexact(name):
    t = THRESHOLDS[name]
    bands = boundary_bands(5, SHAPE, t)
    got = tdiag.compute_diagnostic_tests(*[T(b) for b in bands], t)
    assert_same(got, jdiag.compute_diagnostic_tests(*bands, t))
    assert_same(got, _oracle_tests(bands, t))
    if name != 'one_field':
        # the thresholds decide: the defaults give another layer
        assert (got.numpy() != _oracle_tests(bands, HlsThresholds())).any()


@pytest.mark.parametrize('name', list(THRESHOLDS))
def test_each_int_test_matches_jax(name):
    """The five tests one by one (the packed layer could hide a swap)."""
    t = THRESHOLDS[name]
    et = ExactThresholds.from_thresholds(t)
    bands = boundary_bands(6, SHAPE, t)
    got = tdiag._diag_tests_int(*[T(b) for b in bands], et)
    import jax.numpy as jnp
    want = jdiag._diag_tests_int(*[jnp.asarray(b) for b in bands], et)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bool
        assert_same(g, w, f't{k + 1}')
        assert g.any() and not g.all(), f't{k + 1}'


@pytest.mark.parametrize('name', list(NONE_BOUNDS))
def test_none_bounds_decide_all_false(name):
    """nan and infinite thresholds: a bound of None is all-false, a bound
    beyond int32 is clipped; == JAX and == numpy float64."""
    t = HlsThresholds(**NONE_BOUNDS[name])
    bands = boundary_bands(7, SHAPE, HlsThresholds())
    got = tdiag.compute_diagnostic_tests(*[T(b) for b in bands], t)
    assert_same(got, jdiag.compute_diagnostic_tests(*bands, t))
    with np.errstate(invalid='ignore'):
        assert_same(got, _oracle_tests(bands, t))
    tests = tdiag._diag_tests_int(*[T(b) for b in bands],
                                  ExactThresholds.from_thresholds(t))
    if name in ('nan', 'plus_inf'):
        assert not tests[0].any() and not tests[2].any()
        assert not tests[3].any() and not tests[4].any()
    if name == 'mixed':
        assert not tests[2].any() and not tests[3].any()
    wtr1 = T(np.full(SHAPE, 3, np.uint8))
    lc = make_inputs(7, SHAPE)['landcover']
    got = tmasking.apply_landcover_and_shadow_masks(wtr1, T(bands[3]), T(lc),
                                                    None, t)
    assert_same(got, jmasking.apply_landcover_and_shadow_masks(
        np.full(SHAPE, 3, np.uint8), bands[3], lc, None, t))
    if name in ('nan', 'plus_inf', 'mixed'):
        # nir > lcmask_nir never holds: only the high-intensity developed
        # classes (which read no NIR) are demoted
        assert_same(got.numpy() == 0, (lc >= 100) & (lc < 200))


@pytest.mark.parametrize('name', list(DEGENERATE))
def test_degenerate_ratio_thresholds_follow_numpy(name):
    """Outside the JAX package's exact-boundary domain the port decides as
    NumPy's float64 does. The JAX package's float32 division agrees on
    every pixel with a nonzero denominator (an integer quotient is 0 or at
    least 1/65535 in size); it parts only where x/0 = +-inf meets a
    threshold that float32 rounds to an infinity."""
    t = HlsThresholds(**DEGENERATE[name])
    bands = boundary_bands(8, SHAPE, HlsThresholds())
    got = tdiag.compute_diagnostic_tests(*[T(b) for b in bands], t)
    assert_same(got, _oracle_tests(bands, t))
    want = np.asarray(jdiag.compute_diagnostic_tests(*bands, t))
    g, r, n, s1 = (bands[k] for k in (1, 2, 3, 4))
    zero_den = ((g + s1) == 0) | ((n + r) == 0)    # int16 sums, wrapped
    differ = got.numpy() != want
    assert not (differ & ~zero_den).any()
    if name == 'tiny':
        assert not differ.any()
    else:
        assert differ.any()   # +inf > 1e39 in float64, not in float32


# ---- masking ---------------------------------------------------------------

@pytest.mark.parametrize('name', list(THRESHOLDS))
def test_landcover_mask_inexact_nir(name):
    t = THRESHOLDS[name]
    bands = boundary_bands(9, SHAPE, t)
    inp = make_inputs(9, SHAPE)
    rng = np.random.default_rng(9)
    wtr1 = rng.choice(np.array([0, 1, 2, 3, 4, 254, 255], np.uint8), SHAPE)
    got = tmasking.apply_landcover_and_shadow_masks(
        T(wtr1), T(bands[3]), T(inp['landcover']), T(inp['shadow']), t)
    assert_same(got, jmasking.apply_landcover_and_shadow_masks(
        wtr1, bands[3], inp['landcover'], inp['shadow'], t))
    assert_same(got, oracle.landcover_shadow_masks(
        wtr1, bands[3], inp['landcover'], inp['shadow'], _values(t)))


# ---- the chain in the three modes ----------------------------------------

@pytest.mark.parametrize('mode', ['mask', 'ignore', 'cover'])
@pytest.mark.parametrize('name', list(THRESHOLDS))
def test_chain_inexact_matches_jax(name, mode):
    t = THRESHOLDS[name]
    jcfg = jchain.DswxChainConfig(thresholds=t,
                                  mask_adjacent_to_cloud_mode=mode)
    tcfg = tchain.DswxChainConfig.from_reference(jcfg)
    inp = make_inputs(10, SHAPE)
    bands = boundary_bands(10, SHAPE, t)
    extras = {'ocean_mask': inp['ocean'], 'shadow_layer': inp['shadow'],
              'landcover_mask': inp['landcover']}
    want = jchain.dswx_chain(*bands, inp['fmask'], inp['invalid'], jcfg,
                             **extras)
    got = tchain.dswx_chain(*[T(b) for b in bands], T(inp['fmask']),
                            T(inp['invalid']), tcfg,
                            **{k: T(v) for k, v in extras.items()})
    assert sorted(got) == sorted(want)
    for layer in want:
        if layer.startswith('n_'):
            assert int(got[layer]) == int(want[layer]), layer
        else:
            assert_same(got[layer], want[layer], layer)


@pytest.mark.parametrize('minimal', [False, True], ids=['full', 'minimal'])
@pytest.mark.parametrize('mode', ['mask', 'cover'])
def test_batched_wrapper_inexact(mode, minimal):
    """``wtr_layers_batched`` with an inexact config: the plain chain per
    tile, with ``pack_minimal`` and a window, == JAX's chain."""
    t = THRESHOLDS['irrational']
    jcfg = jchain.DswxChainConfig(thresholds=t,
                                  mask_adjacent_to_cloud_mode=mode)
    tcfg = tchain.DswxChainConfig.from_reference(jcfg)
    shape = (48, 64)
    tiles = [dict(make_inputs(20 + k, shape),
                  bands=boundary_bands(20 + k, shape, t)) for k in range(2)]
    args = [T(np.stack([x['bands'][j] for x in tiles])) for j in range(6)]
    args += [T(np.stack([x[k] for x in tiles])) for k in ('fmask',
                                                          'invalid')]
    kw = {k: T(np.stack([x[k] for x in tiles]))
          for k in ('shadow', 'landcover')}
    got = wtr_kernel.wtr_layers_batched(*args, tcfg, **kw, minimal=minimal,
                                        window=(5, 30))
    for k, x in enumerate(tiles):
        want = jchain.dswx_chain(*x['bands'], x['fmask'], x['invalid'],
                                 jcfg, shadow_layer=x['shadow'],
                                 landcover_mask=x['landcover'])
        want = {name: np.asarray(want[name]) for name in wtr_kernel.LAYERS}
        if minimal:
            want = {name: v.numpy() for name, v in wtr_kernel.pack_minimal(
                {name: T(v) for name, v in want.items()}).items()}
            assert sorted(got) == sorted(wtr_kernel.PACKED
                                         + wtr_kernel.COUNTS)
        for name, v in want.items():
            assert_same(got[name][k], v[5:35], f'tile {k} {name}')


# ---- the kernels' parameters ------------------------------------------------

# every set of thresholds of this file, and the defaults
ALL_THRESHOLDS = dict(
    THRESHOLDS, default=HlsThresholds(),
    **{k: HlsThresholds(**v) for k, v in {**NONE_BOUNDS,
                                          **DEGENERATE}.items()})


def _config(name):
    return tchain.DswxChainConfig(thresholds=ALL_THRESHOLDS[name])


@pytest.mark.parametrize('name', list(ALL_THRESHOLDS))
def test_kernel_bounds_decide_as_the_plain_tests(name):
    """The integer bounds the CUDA kernels compare with (one compare a
    band, AWEsh or lcmask test) decide every value a band can hold as the
    plain chain and NumPy's float64 decide it, exact rational or not."""
    t = ALL_THRESHOLDS[name]
    et = ExactThresholds.from_thresholds(t)
    _, bounds, _ = wtr_kernel.kernel_params(_config(name))
    band = np.arange(-32768, 32768, dtype=np.int32)
    for field, kname in wtr_kernel._BAND_LT_FIELDS.items():
        got = band <= getattr(bounds, f'{kname}_le')
        assert_same(tdiag._int_scalar_lt(T(band), getattr(et, field),
                                         getattr(t, field)), got, field)
        with np.errstate(invalid='ignore'):
            np.testing.assert_array_equal(
                got, band.astype(np.float64) < np.float64(getattr(t, field)))
    assert_same(tmasking._nir_gt_lcmask(T(band.astype(np.int16)),
                                        t.lcmask_nir),
                band >= bounds.lcmask_ge, 'lcmask_nir')
    # awesh4 = 4 * awesh, an integer of at most 688,114 in size: its whole
    # range coarsely, and every value next to the threshold
    near = 0 if not np.isfinite(t.awgt) else int(np.clip(
        np.floor(4 * np.float64(t.awgt)), -700000, 700000))
    awesh4 = np.unique(np.concatenate([
        np.arange(-688114, 688115, 997), np.arange(near - 50, near + 50)]))
    with np.errstate(invalid='ignore'):
        np.testing.assert_array_equal(
            awesh4 >= bounds.awesh4_ge,
            awesh4.astype(np.float64) / 4 > np.float64(t.awgt))


@pytest.mark.parametrize('name,f64', [
    ('next_to_rational', 1), ('irrational', 1), ('one_field', 1),
    ('tiny', 1), ('nan', 1), ('default', 0), ('scalars_only', 0)])
def test_kernel_params_flag_the_float64_ratio_tests(name, f64):
    """One ratio threshold without an exact rational sends all four ratio
    tests through the float64 division; inexact band, AWEsh and lcmask
    thresholds alone leave the kernel on its integer rationals."""
    t = (HlsThresholds(awgt=np.e / 10, pswt_1_nir=1500.5,
                       pswt_2_swir2=1000 + 1 / np.e, lcmask_nir=0.1 + 0.2)
         if name == 'scalars_only' else ALL_THRESHOLDS[name])
    params, bounds, _ = wtr_kernel.kernel_params(
        tchain.DswxChainConfig(thresholds=t))
    assert params.ratio_f64 == f64
    et = ExactThresholds.from_thresholds(t)
    for field, kname in wtr_kernel._RATIO_FIELDS.items():
        np.testing.assert_array_equal(getattr(params, f'{kname}_t'),
                                      np.float64(getattr(t, field)))
        if not f64:
            assert (getattr(params, f'{kname}_p'),
                    getattr(params, f'{kname}_q')) == getattr(et, field)[:2]
            assert getattr(params, f'{kname}_q') >= 1
    if name == 'scalars_only':
        assert (bounds.p1_nir_le, bounds.p2_swir2_le, bounds.lcmask_ge,
                bounds.awesh4_ge) == (1500, 1000, 1, 2)


def _kernel_model(bands, config):
    """The int16 diagnostic tests as csrc/wtr_kernel.cu decides them, in
    numpy from the very structs a launch hands the kernel: int32 sums
    wrapped to int16, the ratio tests as float64 quotients (``ratio_f64``)
    or as the sign of q * num - p * den, every other test one compare with
    its bound. Returns the five tests' bits and the lcmask NIR test."""
    P, B, _ = wtr_kernel.kernel_params(config)
    b, g, r, n, s1, s2 = (x.astype(np.int64) for x in bands)

    def wrap16(x):
        return ((x + 32768) & 0xFFFF) - 32768
    mndwi = wrap16(g - s1), wrap16(g + s1)
    ndvi = wrap16(n - r), wrap16(n + r)
    mbsrv, mbsrn = wrap16(g + r), wrap16(n + s1)
    awesh4 = 4 * b + 10 * g - 6 * mbsrn - s2

    def ratio(operands, kname, op):
        num, den = operands
        if P.ratio_f64:
            with np.errstate(divide='ignore', invalid='ignore'):
                q = num.astype(np.float64) / den.astype(np.float64)
            tval = getattr(P, f'{kname}_t')
            return q > tval if op == 'gt' else q < tval
        d = getattr(P, f'{kname}_q') * num - getattr(P, f'{kname}_p') * den
        assert np.abs(d).max() < 2 ** 31
        if op == 'gt':
            return np.where(den >= 0, d > 0, d < 0)
        return np.where(den >= 0, d < 0, d > 0)
    t1 = ratio(mndwi, 'wigt', 'gt')
    t2 = mbsrv > mbsrn
    t3 = awesh4 >= B.awesh4_ge
    t4 = (ratio(mndwi, 'p1_mndwi', 'gt') & (s1 <= B.p1_swir1_le)
          & (n <= B.p1_nir_le) & ratio(ndvi, 'p1_ndvi', 'lt'))
    t5 = (ratio(mndwi, 'p2_mndwi', 'gt') & (b <= B.p2_blue_le)
          & (s1 <= B.p2_swir1_le) & (s2 <= B.p2_swir2_le)
          & (n <= B.p2_nir_le))
    diag = sum(t.astype(np.int32) << k
               for k, t in enumerate((t1, t2, t3, t4, t5)))
    return diag, n >= B.lcmask_ge


@pytest.mark.parametrize('name', list(ALL_THRESHOLDS))
def test_kernel_arithmetic_matches_the_plain_chain(name):
    """A numpy model of the kernels' int16 tests, fed the launch's own
    parameter structs, against the plain chain and the float64 oracle on
    bands pushed onto the boundaries. It guards the host half of the
    kernels' inexact thresholds here, where the kernels cannot run."""
    t = ALL_THRESHOLDS[name]
    pushed = t if name in THRESHOLDS else HlsThresholds()
    bands = boundary_bands(12, SHAPE, pushed)
    diag, nir_bright = _kernel_model(bands, _config(name))
    with np.errstate(invalid='ignore'):
        np.testing.assert_array_equal(diag, _oracle_tests(bands, t))
    assert_same(tdiag.compute_diagnostic_tests(*[T(b) for b in bands], t),
                diag)
    assert_same(tmasking._nir_gt_lcmask(T(bands[3]), t.lcmask_nir),
                nir_bright)


# ---- dispatch ----------------------------------------------------------------

class _OnACard:
    """Stands for a CUDA tensor where only the device and dtype are read."""
    device = torch.device('cuda', 0)
    dtype = torch.int16

    def dim(self):
        return 2

    def unsqueeze(self, dim):
        return self


@pytest.mark.parametrize('why', ['default', 'environment', 'thresholds'])
@pytest.mark.parametrize('entry', ['wtr_layers', 'wtr_layers_batched'])
def test_a_card_always_launches(monkeypatch, entry, why):
    """Tensors on a card go to the launch whatever the config and the
    environment say: inexact thresholds are the kernels' to decide, and the
    reference's ``PROTEUS_TPU_USE_PALLAS`` switch is not read. Only CPU
    tensors run the plain chain."""
    def no_plain(*args, **kwargs):
        raise AssertionError('the plain chain on a card')
    monkeypatch.setattr(wtr_kernel, f'{entry}_plain', no_plain)
    monkeypatch.setattr(wtr_kernel, '_launch',
                        lambda *a, **k: ({'K': [7]}, True))
    monkeypatch.delenv('PROTEUS_TPU_USE_PALLAS', raising=False)
    cfg = tchain.DswxChainConfig()
    if why == 'environment':
        monkeypatch.setenv('PROTEUS_TPU_USE_PALLAS', '0')
    elif why == 'thresholds':
        cfg = _config('irrational')
    if entry == 'wtr_layers_batched':
        monkeypatch.setattr(_OnACard, 'dim', lambda self: 3)
    x = _OnACard()
    out = getattr(wtr_kernel, entry)(x, x, x, x, x, x, x, x, cfg)
    assert out in ({'K': 7}, {'K': [7]})


def test_cpu_tensors_run_the_plain_chain_and_other_devices_raise():
    launches = dict(wtr_kernel.LAUNCHES)
    inp = make_inputs(11, (16, 16))
    out = wtr_kernel.wtr_layers(*[T(b) for b in inp['bands']],
                                T(inp['fmask']), T(inp['invalid']),
                                _config('irrational'))
    assert sorted(out) == sorted(wtr_kernel.LAYERS + ('BROWSE',)
                                 + wtr_kernel.COUNTS)
    assert wtr_kernel.LAUNCHES == launches
    with pytest.raises(ValueError, match='unsupported device'):
        wtr_kernel._on_cpu(torch.device('meta'))


# ---- a whole single-tile run ----------------------------------------------

@pytest.fixture(scope='module')
def inexact_products(tmp_path_factory):
    root = tmp_path_factory.mktemp('inexact_e2e')
    inputs = dict(_inputs(root),
                  hls_thresholds=_values(THRESHOLDS['irrational']))
    dirs = {}
    for name, fn, extra in (('jax', jax_generate, {}),
                            ('torch', generate_dswx_layers,
                             {'device': torch.device('cpu')})):
        out_dir = str(root / name)
        os.makedirs(out_dir)
        assert fn(**inputs, **_outputs(out_dir), **extra) is True
        dirs[name] = out_dir
    return dirs


@pytest.mark.parametrize('name', [f'B{nn:02}_{layer}.tif' for nn, layer in
                                  enumerate(LAYERS, start=1)]
                         + ['BROWSE.tif'])
def test_inexact_product_matches_jax(inexact_products, name):
    want_path = os.path.join(inexact_products['jax'], name)
    got_path = os.path.join(inexact_products['torch'], name)
    with TiffReader(want_path) as r:
        want = r.read()
        want_md = r.metadata()
    with TiffReader(got_path) as r:
        got = r.read()
        got_md = r.metadata()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert compare_dswx_hls_products(want_path, got_path)
    for key in ('SPATIAL_COVERAGE', 'CLOUD_COVERAGE'):
        assert got_md.get(key) == want_md.get(key), key


def test_inexact_product_is_not_trivial(inexact_products):
    with TiffReader(os.path.join(inexact_products['torch'],
                                 'B01_WTR.tif')) as r:
        assert {0, 1, 252, 253} <= set(np.unique(r.read()).tolist())


# ---- a campaign --------------------------------------------------------------

N_JOBS, TILE = 3, 96


@pytest.fixture(scope='module')
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp('inexact_tiles')
    dirs = []
    for t in range(N_JOBS):
        d = str(root / f'tile_{t}')
        synthetic.make_hls_v2_dataset(d, size=TILE, seed=900 + t)
        dirs.append(d)
    anc = dict(dem_file=synthetic.make_dem(str(root), size=TILE),
               landcover_file=synthetic.make_landcover(str(root), size=TILE),
               worldcover_file=synthetic.make_worldcover(str(root),
                                                         size=TILE))
    return dirs, anc


def _jobs(module, dirs, anc, out):
    return [module.TileJob(f'tile_{t}',
                           sorted(glob.glob(os.path.join(d, '*.tif'))),
                           os.path.join(out, f'tile_{t}'),
                           product_id=f'tile_{t}', **anc)
            for t, d in enumerate(dirs)]


@pytest.mark.parametrize('case', ['mask', 'cover', 'packed'])
def test_campaign_inexact_matches_jax(tiles, tmp_path, monkeypatch, case):
    """Both runners over the same jobs with inexact thresholds: every
    product file array-equal. 'packed' runs the port's step with the
    minimal outputs, through ``pack_minimal`` and the host derivation."""
    import functools
    dirs, anc = tiles
    mode = 'cover' if case == 'cover' else 'mask'
    t = THRESHOLDS['irrational']
    jcampaign.ANCILLARY_CACHE.clear()
    jout = str(tmp_path / 'jax')
    jrunner = jcampaign.CampaignRunner(
        config=jchain.DswxChainConfig(thresholds=t,
                                      mask_adjacent_to_cloud_mode=mode),
        manifest_path=os.path.join(jout, 'm.json'), save_browse=True)
    assert jrunner.run(_jobs(jcampaign, dirs, anc, jout))['tiles_done'] \
        == N_JOBS
    if case == 'packed':
        monkeypatch.setattr(tcampaign, 'make_campaign_step',
                            functools.partial(tcampaign.make_campaign_step,
                                              minimal=True))
    tcampaign.ANCILLARY_CACHE.clear()
    tout = str(tmp_path / 'torch')
    runner = tcampaign.CampaignRunner(
        config=tchain.DswxChainConfig(thresholds=t,
                                      mask_adjacent_to_cloud_mode=mode),
        mesh=[torch.device('cpu')] * 2, tiles_per_device=2,
        manifest_path=os.path.join(tout, 'm.json'), save_browse=True)
    stats = runner.run(_jobs(tcampaign, dirs, anc, tout))
    assert stats['tiles_done'] == N_JOBS and stats['tiles_failed'] == 0
    want = sorted(glob.glob(os.path.join(jout, '*', '*.tif')))
    assert len(want) == N_JOBS * 11
    for wf in want:
        gf = os.path.join(tout, os.path.relpath(wf, jout))
        with TiffReader(wf) as rw, TiffReader(gf) as rg:
            np.testing.assert_array_equal(rg.read(), rw.read(), err_msg=gf)
        assert compare_dswx_hls_products(wf, gf), gf
    tcampaign.ANCILLARY_CACHE.clear()
    jcampaign.ANCILLARY_CACHE.clear()
