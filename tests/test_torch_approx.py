"""The port's single-pass functions against proteus_tpu's (JAX on the
CPU), on the same inputs made with numpy from a seed, at most 256^2 and
with no float32 subnormals (JAX's CPU backend flushes them).

Tolerances:

- ``dilate_square`` and ``dilate_disk``: 0, dtypes included.
- ``compute_hillshade``: a byte may differ only where either package's
  uncertainty band (the second output of ``_hillshade_comparison_space``)
  is set.
- ``compute_opera_shadow_layer``: a pixel may differ only inside the
  epsilon band that the port's exact variant sends to the host
  (``_shadow_comparison_space``), and fewer than 1e-4 of the pixels may
  differ.
- ``otsu_binarize``: the same histogram and bin midpoints, and the same
  threshold bin expected; where the argmax bins differ, their float64
  inter-class variances lie within 1e-6 relative of each other, and only
  pixels between the two thresholds differ.
- ``compute_otsu_shadow_layer``: the hillshade's rule on the bytes and the
  Otsu's on the port's bytes; a mask pixel may differ only where the bytes
  may, or between the two thresholds.

The JAX suite's analytic checks (``tests/test_dswx_core.py:333-401``: the
Otsu against NumPy's histogram, the disk against SciPy's distance
transform, the flat and the sun-facing hillshade, the flat DEM's shadow)
are cases of these tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import distance_transform_edt

import oracle
from proteus_tpu.models.dswx import shadow as jshadow
from proteus_tpu.ops import morphology as jmorph
from proteus_tpu.ops import otsu as jotsu
from proteus_tpu_torch.models.dswx import shadow as tshadow
from proteus_tpu_torch.ops import morphology as tmorph
from proteus_tpu_torch.ops import otsu as totsu

torch.set_num_threads(1)

SIZE = 256
GEOMETRIES = [(135.0, 45.0), (277.3, 18.0), (80.0, 70.0)]
TERRAINS = ('smooth', 'plateau_6000m', 'nan_holed', 'quadratic_sweep')


def _no_subnormals(a):
    finite = a[np.isfinite(a)]
    tiny = np.finfo(np.float32).tiny
    assert not ((finite != 0) & (np.abs(finite) < tiny)).any()
    return a


def _terrains():
    """tools/hillshade_tpu_parity.py:29-40 at 256^2."""
    rng = np.random.default_rng(20260818)
    base = rng.normal(0, 1, (SIZE, SIZE)).cumsum(0).cumsum(1)
    smooth = (base / np.abs(base).max() * 800 + 200).astype(np.float32)
    plateau = (6000.0 + rng.normal(0, 2.0, (SIZE, SIZE))).astype(np.float32)
    holed = smooth.copy()
    holed[rng.random((SIZE, SIZE)) < 0.05] = np.nan
    col = np.arange(SIZE, dtype=np.float64)
    sweep = np.tile((0.002 * col ** 2).astype(np.float32), (SIZE, 1))
    out = {'smooth': smooth, 'plateau_6000m': plateau, 'nan_holed': holed,
           'quadratic_sweep': sweep}
    return {k: _no_subnormals(v) for k, v in out.items()}


TERRAIN = _terrains()


# ---------------------------------------------------------------------------
# dilations, tolerance 0
# ---------------------------------------------------------------------------

def _border_points():
    x = np.zeros((64, 69), bool)
    for i, j in [(0, 0), (0, 68), (63, 0), (63, 68), (1, 30), (30, 1),
                 (62, 17), (20, 67), (32, 32)]:
        x[i, j] = True
    return x


def _edt_points():
    """tests/test_dswx_core.py:366-368."""
    x = np.zeros((48, 48), bool)
    x[20, 20] = True
    x[5, 40] = True
    return x


FIELDS = {
    'border_points': _border_points,
    'edt_points': _edt_points,
    'random_sparse': lambda: np.random.default_rng(1).random((SIZE, SIZE))
    < 0.002,
    'random_dense': lambda: np.random.default_rng(2).random((SIZE, SIZE))
    < 0.3,
    'tiny': lambda: np.random.default_rng(3).random((5, 7)) < 0.2,
}
RADII = (0, 0.5, 1, 6, 6.9, 34)


@pytest.mark.parametrize('name', list(FIELDS) + ['uint8_values'])
def test_dilate_square_matches_jax(name):
    if name == 'uint8_values':
        # the reference ORs in the input's dtype: bitwise for integers
        x = np.random.default_rng(4).integers(0, 256, (33, 40), np.uint8)
    else:
        x = FIELDS[name]()
    want = np.asarray(jmorph.dilate_square(jnp.asarray(x)))
    got = tmorph.dilate_square(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('radius', RADII)
@pytest.mark.parametrize('name', list(FIELDS))
def test_dilate_disk_matches_jax_and_scipy(name, radius):
    x = FIELDS[name]()
    want = np.asarray(jmorph.dilate_disk(jnp.asarray(x), radius))
    got = tmorph.dilate_disk(torch.from_numpy(x), radius).numpy()
    assert got.dtype == want.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    # analytic: the disk of radius r is where the Euclidean distance to
    # the nearest set pixel is at most r
    np.testing.assert_array_equal(got, distance_transform_edt(~x) <= radius)


# ---------------------------------------------------------------------------
# hillshade: bytes differ only in either package's band
# ---------------------------------------------------------------------------

def _flat():
    return np.full((32, 32), 500.0, np.float32)


def _east_dipping():
    xx = np.mgrid[0:64, 0:64][1]
    return -(xx.astype(np.float32)) * 10.0


HILLSHADE_CASES = {
    f'{name}-{az}-{elev}-{psy}': (TERRAIN[name], az, elev, 30.0, psy)
    for name in TERRAINS for az, elev in GEOMETRIES for psy in (-30.0, 30.0)}
HILLSHADE_CASES.update({
    # tests/test_dswx_core.py:374-393
    'flat': (_flat(), 135.0, 45.0, 30.0, -30.0),
    'east_dipping_lit': (_east_dipping(), 90.0, 30.0, 30.0, -30.0),
    'east_dipping_dark': (_east_dipping(), 270.0, 30.0, 30.0, -30.0),
})


def _hillshade_both(dem, az, elev, psx, psy):
    """Both packages' single-pass bytes, held to the band rule; returns
    (port's, JAX's, either band)."""
    got = tshadow.compute_hillshade(torch.from_numpy(dem), az, elev, psx,
                                    psy)
    assert got.dtype == torch.uint8
    got = got.numpy()
    want = np.asarray(jshadow.compute_hillshade(jnp.asarray(dem), az, elev,
                                                psx, psy))
    band_t = tshadow._hillshade_comparison_space(
        torch.from_numpy(dem), tshadow._hillshade_consts_dd(az, elev),
        psx, psy)[1].numpy()
    band_j = np.asarray(jshadow._hillshade_comparison_space(
        jnp.asarray(dem), jshadow._hillshade_consts_dd(az, elev), psx=psx,
        psy=psy)[1])
    band = band_t | band_j
    outside = (got != want) & ~band
    assert not outside.any(), f'{int(outside.sum())} bytes outside the band'
    # GDAL's edge ring
    assert not got[0].any() and not got[-1].any()
    assert not got[:, 0].any() and not got[:, -1].any()
    return got, want, band


@pytest.mark.parametrize('case', list(HILLSHADE_CASES))
def test_hillshade_matches_jax(case):
    dem, az, elev, psx, psy = HILLSHADE_CASES[case]
    got, _, _ = _hillshade_both(dem, az, elev, psx, psy)
    if case == 'flat':
        v = np.float32(1.0 + 254.0 * np.sin(np.radians(45.0)))
        assert (got[1:-1, 1:-1] == int(np.trunc(v + np.float32(0.5)))).all()
    if case.startswith('east_dipping'):
        # the slope dips to the east: the sun in the east lights it
        other = dict(east_dipping_lit=270.0, east_dipping_dark=90.0)[case]
        flipped = tshadow.compute_hillshade(torch.from_numpy(dem), other,
                                            elev, psx, psy).numpy()
        lit, dark = ((got, flipped) if case == 'east_dipping_lit'
                     else (flipped, got))
        assert lit[32, 32] > dark[32, 32]


# ---------------------------------------------------------------------------
# the single-pass sun-local-incidence shadow: differences inside the band
# ---------------------------------------------------------------------------

def _core_terrain():
    """tests/test_dswx_core.py:236-239."""
    y, x = np.mgrid[0:128, 0:128]
    dem = (200 * np.sin(x / 17.0) * np.cos(y / 23.0)
           + 0.5 * x + 30 * np.exp(-((x - 60) ** 2 + (y - 70) ** 2)
                                   / 400.0)).astype(np.float32)
    return _no_subnormals(dem)


SHADOW_ANGLES = (152.595427, 90 - 27.085305, -5.0, 40.0)
SHADOW_CASES = {
    'core_terrain': (_core_terrain(), (127.5, 37.2, -5.0, 40.0), 30, 30),
    # tests/test_dswx_core.py:388-401: flat ground, the incidence angle is
    # the zenith angle
    'flat_high_sun': (np.full((32, 32), 100.0, np.float32),
                      (100.0, 60.0, -5.0, 40.0), 30, 30),
    'flat_low_sun': (np.full((32, 32), 100.0, np.float32),
                     (100.0, 10.0, -5.0, 40.0), 30, 30),
    'spacing_20_-10': (_core_terrain(), (127.5, 37.2, -5.0, 40.0), 20.0,
                       -10.0),
}
SHADOW_CASES.update({name: (TERRAIN[name], SHADOW_ANGLES, 30, 30)
                     for name in TERRAINS})


def _shadow_band(dem, angles, psx, psy):
    """The epsilon band that the port's exact variant sends to the host."""
    return tshadow._exact_comparison_space(torch.from_numpy(dem), angles,
                                           psx, psy)[3].numpy()


@pytest.mark.parametrize('tensor_angles', [False, True])
@pytest.mark.parametrize('case', list(SHADOW_CASES))
def test_opera_shadow_matches_jax(case, tensor_angles):
    dem, angles, psx, psy = SHADOW_CASES[case]
    if tensor_angles:
        # arrays in JAX, float32 tensors in the port
        t_angles = [torch.tensor(np.float32(a)) for a in angles]
        j_angles = [jnp.float32(a) for a in angles]
    else:
        t_angles = j_angles = angles
    got = tshadow.compute_opera_shadow_layer(torch.from_numpy(dem),
                                             *t_angles, psx, psy)
    assert got.dtype == torch.bool and got.shape == dem.shape
    got = got.numpy()
    want = np.asarray(jshadow.compute_opera_shadow_layer(
        jnp.asarray(dem), *j_angles, psx, psy))
    differ = got != want
    outside = differ & ~_shadow_band(dem, angles, psx, psy)
    assert not outside.any(), f'{int(outside.sum())} px outside the band'
    assert differ.mean() < 1e-4
    # the float64 oracle, as the JAX suite holds its own
    # (tests/test_dswx_core.py:240-245)
    ref = oracle.opera_shadow(dem.astype(np.float64), *angles, psx, psy)
    assert (got != ref).mean() < 1e-4
    if case.startswith('flat'):
        # zenith 30 <= 40: lit; zenith 80 > 40 with slope 0 > -5: lit
        assert got.all()


# ---------------------------------------------------------------------------
# Otsu: the same bin, or bins whose float64 variances tie
# ---------------------------------------------------------------------------

def _jax_bin(image):
    """proteus_tpu/ops/otsu.py:17-39 up to its argmax, in JAX: (k, the bin
    midpoints, the histogram). The caller checks that JAX's own mask is
    ``image > bin_mids[k]``."""
    x = jnp.asarray(image).astype(jnp.float32).ravel()
    bins = 256
    lo, hi = jnp.min(x), jnp.max(x)
    span = hi - lo
    idx = jnp.floor((x - lo) / jnp.where(span == 0, 1.0, span) * bins)
    idx = jnp.clip(idx, 0, bins - 1).astype(jnp.int32)
    hist = jnp.zeros(bins, jnp.float32).at[idx].add(1.0)
    edges = lo + span * jnp.arange(bins + 1, dtype=jnp.float32) / bins
    bin_mids = 0.5 * (edges[:-1] + edges[1:])
    weight1 = jnp.cumsum(hist)
    weight2 = jnp.cumsum(hist[::-1])[::-1]
    mean1 = jnp.cumsum(hist * bin_mids) / weight1
    mean2 = (jnp.cumsum((hist * bin_mids)[::-1]) / weight2[::-1])[::-1]
    icv = weight1[:-1] * weight2[1:] * (mean1[:-1] - mean2[1:]) ** 2
    k = jnp.argmax(jnp.nan_to_num(icv, nan=-1.0))
    return int(k), np.asarray(bin_mids), np.asarray(hist)


def _icv64(hist, mids):
    """The inter-class variance in float64 of a histogram and its bin
    midpoints."""
    h = hist.astype(np.float64)
    m = mids.astype(np.float64)
    w1 = np.cumsum(h)
    w2 = np.cumsum(h[::-1])[::-1]
    with np.errstate(invalid='ignore', divide='ignore'):
        m1 = np.cumsum(h * m) / w1
        m2 = (np.cumsum((h * m)[::-1]) / w2[::-1])[::-1]
    return w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2


def _otsu_both(image):
    """Both packages' masks on ``image``, held to the Otsu rule; returns
    (port's, JAX's, the lower and the upper of the two thresholds)."""
    got = totsu.otsu_binarize(torch.from_numpy(image))
    assert got.dtype == torch.bool and got.shape == image.shape
    got = got.numpy()
    want = np.asarray(jotsu.otsu_binarize(jnp.asarray(image)))
    k, mids, hist = (t.numpy() for t in
                     totsu.threshold_bin(torch.from_numpy(image)))
    k = int(k)
    kj, mids_j, hist_j = _jax_bin(image)
    np.testing.assert_array_equal(want, image > mids_j[kj])
    np.testing.assert_array_equal(hist, hist_j)
    np.testing.assert_array_equal(mids, mids_j)
    if k != kj:
        icv = _icv64(hist, mids)
        assert abs(icv[k] - icv[kj]) <= 1e-6 * max(icv[k], icv[kj]), \
            (k, kj, icv[k], icv[kj])
    lo, hi = sorted((mids[k], mids[kj]))
    differ = got != want
    assert ((image > lo) & (image <= hi))[differ].all()
    return got, want, lo, hi


def _bimodal():
    """tests/test_dswx_core.py:338-339."""
    rng = np.random.default_rng(42)
    return (rng.normal(120, 40, (128, 128))
            + 80 * (rng.random((128, 128)) > 0.6)).astype(np.float32)


def _numpy_otsu(x):
    """tests/test_dswx_core.py:340-349: the reference's algorithm
    re-derived in NumPy."""
    hist, edges = np.histogram(x, bins=256)
    mids = 0.5 * (edges[:-1] + edges[1:])
    w1 = np.cumsum(hist)
    w2 = np.cumsum(hist[::-1])[::-1]
    with np.errstate(invalid='ignore', divide='ignore'):
        m1 = np.cumsum(hist * mids) / w1
        m2 = (np.cumsum((hist * mids)[::-1]) / w2[::-1])[::-1]
        icv = w1[:-1] * w2[1:] * (m1[:-1] - m2[1:]) ** 2
    return x > mids[:-1][np.nanargmax(icv)]


OTSU_CASES = {
    'bimodal': _bimodal,
    'normal_unit': lambda: np.random.default_rng(5).normal(
        0.5, 0.2, (128, 128)).astype(np.float32),
    'constant': lambda: np.full((16, 24), 7.25, np.float32),
    'uint8': lambda: np.random.default_rng(6).integers(
        0, 256, (97, 131)).astype(np.uint8),
    'int16': lambda: (np.random.default_rng(7).normal(0, 3000, (SIZE, SIZE))
                      .astype(np.int16)),
}


@pytest.mark.parametrize('case', list(OTSU_CASES))
def test_otsu_matches_jax(case):
    image = OTSU_CASES[case]()
    got, _, _, _ = _otsu_both(image)
    if case == 'bimodal':
        # float32 binning moves edge pixels only
        assert (got != _numpy_otsu(image)).mean() < 1e-3
    if case == 'constant':
        assert not got.any()


@pytest.mark.parametrize('case', [c for c in HILLSHADE_CASES
                                  if c.split('-')[0] in TERRAINS])
def test_otsu_shadow_layer_matches_jax(case):
    dem, az, elev, psx, psy = HILLSHADE_CASES[case]
    got = tshadow.compute_otsu_shadow_layer(torch.from_numpy(dem), az, elev,
                                            psx, psy)
    assert got.dtype == torch.bool
    got = got.numpy()
    want = np.asarray(jshadow.compute_otsu_shadow_layer(
        jnp.asarray(dem), az, elev, psx, psy))
    hs, hs_j, band = _hillshade_both(dem, az, elev, psx, psy)
    # each package's mask is its Otsu of its own bytes
    np.testing.assert_array_equal(
        got, totsu.otsu_binarize(torch.from_numpy(hs)).numpy())
    np.testing.assert_array_equal(
        want, np.asarray(jotsu.otsu_binarize(jnp.asarray(hs_j))))
    _, _, lo, hi = _otsu_both(hs)
    between = (hs > lo) & (hs <= hi)
    assert not ((got != want) & ~band & ~between).any()
