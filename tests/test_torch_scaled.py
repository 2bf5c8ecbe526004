"""Offset-and-scaled (float32) inputs of the port against proteus_tpu (JAX
on the CPU) and NumPy's float32, tolerance 0.

The bands are made as the scaled ingest makes them, with operands pushed
within +-2 float32 ULPs of the rounding boundary of each of the four ratio
thresholds, so that the division-based decisions of the port (the plain
chain here, kernel K3 on the card) are held against the JAX package's
division-free exact boundary tests exactly where they could part. Every
layer is an integer array, so equality is exact.
"""

import itertools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from chip_smoke import RATIO_TESTS, scaled_bands
from proteus_tpu.core.thresholds import HlsThresholds
from proteus_tpu.io.tiff import TiffReader
from proteus_tpu.models.dswx import chain as jchain
from proteus_tpu.models.dswx import diagnostics as jdiag
from proteus_tpu.models.dswx import masking as jmasking
from proteus_tpu.ops.pallas.wtr_kernel import make_wtr_kernel
from proteus_tpu.runtime.orchestrator import \
    generate_dswx_layers as jax_generate
from proteus_tpu_torch.models.dswx import chain as tchain
from proteus_tpu_torch.models.dswx import diagnostics as tdiag
from proteus_tpu_torch.models.dswx import masking as tmasking
from proteus_tpu_torch.ops import wtr_kernel
from proteus_tpu_torch.runtime.compare import compare_dswx_hls_products
from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers
from test_torch_chain import T, assert_same, make_inputs
from test_torch_e2e import LAYERS, _inputs, _outputs

torch.set_num_threads(1)

SHAPE = (128, 128)
THRESHOLDS = {
    'default': HlsThresholds(),
    'shifted': HlsThresholds(wigt=-0.05, awgt=-0.25, pswt_1_ndvi=0.35,
                             pswt_2_mndwi=0.1, pswt_1_nir=0.15,
                             pswt_2_swir2=0.07),
    # not exact rationals: the float path needs none
    'inexact': HlsThresholds(wigt=0.12345678, pswt_1_mndwi=-1 / 3,
                             pswt_2_mndwi=-0.6180339887, pswt_1_ndvi=1 / 3,
                             awgt=1e-7, pswt_2_blue=0.1 + 0.2,
                             lcmask_nir=0.1 + 0.2),
}


def _oracle_thresholds(t):
    return {k: getattr(t, k) for k in t.__dataclass_fields__}


# ---- diagnostics -------------------------------------------------------

@pytest.mark.parametrize('name', list(THRESHOLDS))
def test_diagnostic_tests_float(name):
    t = THRESHOLDS[name]
    bands = scaled_bands(np.random.default_rng(5), SHAPE, t)
    got = tdiag.compute_diagnostic_tests(*[T(b) for b in bands], t)
    assert_same(got, jdiag.compute_diagnostic_tests(*bands, t))
    with np.errstate(divide='ignore', invalid='ignore'):
        want = oracle.diagnostic_tests(*bands, _oracle_thresholds(t))
    assert_same(got, want)


@pytest.mark.parametrize('name', list(THRESHOLDS))
def test_inputs_sit_on_the_rounding_boundaries(name):
    """Each ratio test has pixels whose float32 quotient is its threshold
    and pixels whose quotient is the next float32 past it, so the tests
    above decide pixels on both sides of every boundary."""
    t = THRESHOLDS[name]
    blue, green, red, nir, swir1, swir2 = scaled_bands(
        np.random.default_rng(5), SHAPE, t)
    with np.errstate(divide='ignore', invalid='ignore'):
        mndwi = (green - swir1) / (green + swir1)
        ndvi = (nir - red) / (nir + red)
    for field, op in RATIO_TESTS:
        q = ndvi if field == 'pswt_1_ndvi' else mndwi
        t32 = np.float32(getattr(t, field))
        past = np.nextafter(t32, np.float32(np.inf if op == 'gt'
                                            else -np.inf))
        assert (q == t32).any(), field
        assert (q == past).any(), field
    assert np.isnan(mndwi).any() and np.isnan(ndvi).any()


# ---- masking -------------------------------------------------------------

@pytest.mark.parametrize('lcmask_nir', [1200, 0.1 + 0.2],
                         ids=['default', 'inexact'])
def test_masking_float_nir(lcmask_nir):
    """The aerosol NIR test and the landcover NIR test on float32 NIR,
    with NIR values on both sides of each threshold's float32."""
    rng = np.random.default_rng(6)
    t = HlsThresholds(lcmask_nir=lcmask_nir)
    near = []
    for v in (1000.0, lcmask_nir):
        v32 = np.float32(v)
        near += [v32, np.nextafter(v32, np.float32(0)),
                 np.nextafter(v32, np.float32(np.inf))]
    nir = np.where(rng.random(SHAPE) < 0.5,
                   rng.choice(np.array(near, np.float32), SHAPE),
                   np.float32(1e-4) * rng.integers(1, 18000, SHAPE).astype(
                       np.float32))
    inp = make_inputs(7, SHAPE)
    wtr1 = rng.choice(np.array([0, 1, 2, 3, 4, 254, 255], np.uint8), SHAPE)
    lut = jchain.DswxChainConfig().aerosol_lut()
    fmask = rng.choice(np.array([0, 96, 128, 160, 192, 224], np.uint8),
                       SHAPE)
    cloud = jmasking.compute_preliminary_cloud_layer(fmask, 'mask')
    wj, cj = jmasking.apply_aerosol_class_remapping(wtr1, nir, cloud,
                                                    fmask, lut)
    wt, ct = tmasking.apply_aerosol_class_remapping(
        T(wtr1), T(nir), T(np.asarray(cloud)), T(fmask), lut)
    assert_same(wt, wj)
    assert_same(ct, cj)
    assert not np.array_equal(np.asarray(wj), wtr1)
    w2j = jmasking.apply_landcover_and_shadow_masks(
        wj, nir, inp['landcover'], inp['shadow'], t)
    w2t = tmasking.apply_landcover_and_shadow_masks(
        wt, T(nir), T(inp['landcover']), T(inp['shadow']), t)
    assert_same(w2t, w2j)


def test_inexact_lcmask_on_int16_and_float32():
    t = HlsThresholds(lcmask_nir=0.1 + 0.2)
    inp = make_inputs(8, SHAPE)
    wtr1 = T(np.ones(SHAPE, np.uint8))
    for nir in (inp['bands'][3], inp['bands'][3].astype(np.float32)):
        got = tmasking.apply_landcover_and_shadow_masks(
            wtr1, T(nir), T(inp['landcover']), None, t)
        assert_same(got, jmasking.apply_landcover_and_shadow_masks(
            np.ones(SHAPE, np.uint8), nir, inp['landcover'], None, t))


# ---- the kernel module ---------------------------------------------------

# the float32 Pallas kernel is slow in interpret mode: three cases
SCALED_KERNEL_CASES = [('mask', 'default', True, True),
                       ('ignore', 'inexact', False, True),
                       ('mask', 'shifted', True, False)]


@pytest.mark.parametrize('mode,name,with_ancillaries,browse',
                         SCALED_KERNEL_CASES)
def test_scaled_kernel_plain_matches_pallas_interpret(mode, name,
                                                      with_ancillaries,
                                                      browse):
    """K3's plain version (the CPU path of ``wtr_layers``) against the
    Pallas kernel with ``float_inputs``."""
    jcfg = jchain.DswxChainConfig(
        thresholds=THRESHOLDS[name], mask_adjacent_to_cloud_mode=mode,
        cloud_in_browse='nodata' if with_ancillaries else 'gray')
    tcfg = tchain.DswxChainConfig.from_reference(jcfg)
    shape = (64, 128)
    inp = make_inputs(9, shape)
    inp['bands'] = scaled_bands(np.random.default_rng(9), shape,
                                THRESHOLDS[name])
    extras = ('ocean', 'shadow', 'landcover') if with_ancillaries else ()
    kernel = make_wtr_kernel(jcfg, with_ocean=with_ancillaries,
                             with_shadow=with_ancillaries,
                             with_landcover=with_ancillaries,
                             compute_browse=browse, block_rows=32,
                             interpret=True, float_inputs=True)
    want = kernel(*[jnp.asarray(b) for b in inp['bands']],
                  jnp.asarray(inp['fmask']), jnp.asarray(inp['invalid']),
                  *[jnp.asarray(inp[k]) for k in extras])
    got = wtr_kernel.wtr_layers(*[T(b) for b in inp['bands']],
                                T(inp['fmask']), T(inp['invalid']), tcfg,
                                compute_browse=browse,
                                **{k: T(inp[k]) for k in extras})
    assert sorted(got) == sorted(want)
    for layer in want:
        assert_same(got[layer], want[layer], layer)


@pytest.mark.parametrize('mode,name', list(itertools.product(
    ('mask', 'cover'), ('default', 'inexact'))))
def test_scaled_chain_matches_jax(mode, name):
    jcfg = jchain.DswxChainConfig(thresholds=THRESHOLDS[name],
                                  mask_adjacent_to_cloud_mode=mode)
    tcfg = tchain.DswxChainConfig.from_reference(jcfg)
    inp = make_inputs(10, SHAPE)
    bands = scaled_bands(np.random.default_rng(10), SHAPE, THRESHOLDS[name])
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


# ---- a whole product run with --offset-and-scale-inputs ------------------

@pytest.fixture(scope='module')
def scaled_products(tmp_path_factory):
    root = tmp_path_factory.mktemp('scaled_e2e')
    inputs = dict(_inputs(root), flag_offset_and_scale_inputs=True)
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
def test_scaled_product_matches_jax(scaled_products, name):
    want_path = os.path.join(scaled_products['jax'], name)
    got_path = os.path.join(scaled_products['torch'], name)
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


def test_scaled_product_is_not_trivial(scaled_products):
    with TiffReader(os.path.join(scaled_products['torch'],
                                 'B01_WTR.tif')) as r:
        wtr = r.read()
    assert {0, 1, 252, 253} <= set(np.unique(wtr).tolist())
