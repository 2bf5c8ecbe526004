"""Parity of the PyTorch exact terrain shadow (SHAD, 'sun_local_inc_angle')
with proteus_tpu's (JAX on the CPU) and with the host float64 decision,
tolerance 0.

Besides random terrain, the cases include DEMs built so that pixels land
in the epsilon band around the decision boundaries (where the host
re-decides them in float64): a noisy plane at the boundary, and a plane so
flat at the boundary that nearly every pixel lies in the band (the JAX
package caps its band and decides such a tile wholly on the host; the
port decides any band size pixel by pixel).
"""

import numpy as np
import pytest
import torch

from proteus_tpu.models.dswx.shadow import \
    compute_opera_shadow_layer_exact as jax_shadow
from proteus_tpu_torch.models.dswx import shadow as tshadow

torch.set_num_threads(1)

SUN_AZ, SUN_ELEV = 152.595427, 90 - 27.085305
MIN_SLOPE, MAX_INC = -5.0, 40.0
ANGLES = (SUN_AZ, SUN_ELEV, MIN_SLOPE, MAX_INC)


def _ramp_at_boundary(n, noise, seed):
    """A plane whose terrain normal sits on the x_crit (cos incidence)
    boundary, plus float32 noise of ``noise`` metres."""
    x_crit, _ = tshadow._decision_boundaries(*ANGLES)
    tsv_x, _, tsv_z, _, _ = tshadow._sun_vector_f64(SUN_AZ, SUN_ELEV)
    lo, hi = -5.0, 0.0  # x(tn_x) is monotone on this bracket
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        x = (mid * tsv_x + tsv_z) / np.sqrt(mid * mid + 1)
        lo, hi = (mid, hi) if x < x_crit else (lo, mid)
    tn_x = 0.5 * (lo + hi)
    # tn_x = -gx / 30 with gx the column gradient of h = a * col
    a = -tn_x * 30.0
    rng = np.random.default_rng(seed)
    cols = np.arange(n, dtype=np.float64)[None, :].repeat(n, 0)
    dem = a * cols + noise * rng.standard_normal((n, n))
    return dem.astype(np.float32)


def _terrain(n, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    dem = (120 * np.sin(xx / 7.0) * np.cos(yy / 5.0) + 0.08 * xx
           + 25 * rng.standard_normal((n, n)))
    return dem.astype(np.float32)


def _band_size(dem):
    x_crit, t_crit = tshadow._decision_boundaries(*ANGLES)
    f32 = (lambda v: torch.tensor(np.float32(v)))
    tsv = tuple(f32(v) for v in tshadow._sun_vector_f64(SUN_AZ, SUN_ELEV))
    eps_t = np.float32(tshadow._EPS_T_REL * (1.0 + min(abs(t_crit), 1e30)))
    *_, uncertain = tshadow._shadow_comparison_space(
        torch.from_numpy(dem), tsv, f32(x_crit), f32(t_crit),
        f32(tshadow._EPS_X), f32(eps_t))
    return int(uncertain.sum())


DEMS = {
    'terrain': lambda: _terrain(96, 3),
    'epsilon-band': lambda: _ramp_at_boundary(96, 2e-3, 4),
    'flat-boundary': lambda: _ramp_at_boundary(140, 0.0, 5),
}


@pytest.mark.parametrize('name', list(DEMS))
def test_shadow_matches_jax_and_host(name):
    dem = DEMS[name]()
    band = _band_size(dem)
    if name == 'epsilon-band':
        assert 0 < band < dem.size // 2
    if name == 'flat-boundary':
        assert band > dem.size // 2
    got = tshadow.compute_opera_shadow_layer_exact(torch.from_numpy(dem),
                                                   *ANGLES)
    assert got.dtype == torch.bool
    want_jax = jax_shadow(dem, *ANGLES)
    want_host = tshadow._host_shadow_exact(dem, *ANGLES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jax))
    np.testing.assert_array_equal(got.numpy(), want_host)
    if name != 'terrain':
        assert got.numpy().any() and not got.numpy().all()


def test_float64_dem_is_decided_on_the_host():
    dem = _terrain(64, 8).astype(np.float64)
    got = tshadow.compute_opera_shadow_layer_exact(torch.from_numpy(dem),
                                                   *ANGLES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_shadow(dem, *ANGLES)))


def test_gradient_matches_numpy():
    dem = _terrain(33, 9)
    gy, gx = np.gradient(dem)
    t = torch.from_numpy(dem)
    np.testing.assert_array_equal(tshadow._np_gradient_axis(t, 0).numpy(),
                                  gy)
    np.testing.assert_array_equal(tshadow._np_gradient_axis(t, 1).numpy(),
                                  gx)
