"""Terrain shadow layer (SHAD) from a pre-warped DEM: the exact
'sun_local_inc_angle' algorithm.

Port of ``proteus_tpu/models/dswx/shadow.py:53-64, 111-358``. The device
decides each pixel in comparison space (the cosine of the incidence angle
against a float64-bisected boundary; likewise the tangent of the
directional slope) and flags an epsilon band of near-boundary pixels; the
host re-decides only those in float64 with the reference's dtype mix, from
the device *gradients* (subtraction and an exact x0.5, so bit-identical to
``np.gradient``). Division by a Python scalar on CUDA multiplies by the
reciprocal (up to 1 ULP off IEEE division), so the device terrain normals
only place a pixel in or out of the band; they are never handed to the
host. The result is bit-identical to the reference's float64 chain.

The float64 host helpers below are copied from ``proteus_tpu`` because
their module imports ``jax``; each names its source lines. The 'otsu'
algorithm (the hillshade) is not ported yet.
"""

import struct

import numpy as np
import torch

# copied from proteus_tpu/models/dswx/shadow.py:111-115
_EPS_X = 1e-5          # band half-width in cos(incidence) space
_EPS_T_REL = 1e-5      # band half-width in tan(slope) space, x(1+|t_crit|)


def _np_gradient_axis(h, axis):
    """np.gradient along one axis (float32): central differences in the
    interior, one-sided at the edges (shadow.py:53-64)."""
    h = h.to(torch.float32)
    n = h.shape[axis]
    interior = (h.narrow(axis, 2, n - 2) - h.narrow(axis, 0, n - 2)) * 0.5
    first = h.narrow(axis, 1, 1) - h.narrow(axis, 0, 1)
    last = h.narrow(axis, n - 1, 1) - h.narrow(axis, n - 2, 1)
    return torch.cat([first, interior, last], dim=axis)


# copied from proteus_tpu/models/dswx/shadow.py:118-161
def _float_to_ordered_int(x):
    i = struct.unpack('<q', struct.pack('<d', float(x)))[0]
    return i if i >= 0 else -(i & 0x7FFFFFFFFFFFFFFF)


def _ordered_int_to_float(i):
    raw = i if i >= 0 else (-i) | (1 << 63)
    return struct.unpack('<d', struct.pack('<Q', raw & ((1 << 64) - 1)))[0]


def _bisect_largest_true(pred, lo, hi):
    """Largest float64 in [lo, hi] with pred true, for pred monotone
    nonincreasing (true below the boundary); None if pred(lo) is false.
    Bisection runs over the ordered-integer encoding of float64, so the
    boundary is exact to the last ULP."""
    ilo, ihi = _float_to_ordered_int(lo), _float_to_ordered_int(hi)
    if not pred(_ordered_int_to_float(ilo)):
        return None
    if pred(_ordered_int_to_float(ihi)):
        return _ordered_int_to_float(ihi)
    while ihi - ilo > 1:
        mid = (ilo + ihi) // 2
        if pred(_ordered_int_to_float(mid)):
            ilo = mid
        else:
            ihi = mid
    return _ordered_int_to_float(ilo)


def _bisect_smallest_true(pred, lo, hi):
    """Smallest float64 in [lo, hi] with pred true, for pred monotone
    nondecreasing; None if pred never true on the interval."""
    ilo, ihi = _float_to_ordered_int(lo), _float_to_ordered_int(hi)
    if not pred(_ordered_int_to_float(ihi)):
        return None
    if pred(_ordered_int_to_float(ilo)):
        return _ordered_int_to_float(ilo)
    while ihi - ilo > 1:
        mid = (ilo + ihi) // 2
        if pred(_ordered_int_to_float(mid)):
            ihi = mid
        else:
            ilo = mid
    return _ordered_int_to_float(ihi)


# copied from proteus_tpu/models/dswx/shadow.py:164-197
def _sun_vector_f64(sun_azimuth_angle, sun_elevation_angle):
    az = np.radians(np.float64(sun_azimuth_angle))
    zen = np.radians(np.float64(90.0 - np.float64(sun_elevation_angle)))
    return (np.sin(az) * np.sin(zen), np.cos(az) * np.sin(zen),
            np.cos(zen), np.sin(az), np.cos(az))


def _decision_boundaries(sun_azimuth_angle, sun_elevation_angle,
                         min_slope_angle, max_sun_local_inc_angle):
    """Exact float64 decision boundaries in comparison space.

    x_crit: smallest x in [-1, 1] with degrees(arccos(x)) <= max_inc
            (the low-incidence test is x >= x_crit within the domain).
    t_crit: largest t with degrees(arctan(t)) <= min_slope
            (the backslope test is t <= t_crit).
    """
    maxi = float(max_sun_local_inc_angle)
    mins = float(min_slope_angle)

    def p_inc(x):
        with np.errstate(invalid='ignore'):
            return bool(np.degrees(np.arccos(np.float64(x))) <= maxi)

    x_crit = _bisect_smallest_true(p_inc, -1.0, 1.0)
    if x_crit is None:
        x_crit = 2.0  # low-incidence test never true

    def p_slope(t):
        return bool(np.degrees(np.arctan(np.float64(t))) <= mins)

    t_crit = _bisect_largest_true(p_slope, -1.79e308, 1.79e308)
    if t_crit is None:
        t_crit = -1.79e308  # backslope never true -> ~backslope always
    return x_crit, t_crit


def _shadow_comparison_space(dem, tsv, x_crit32, t_crit32, eps_x, eps_t,
                             psx=30, psy=30):
    """Device pass: f32 comparison-space decisions + uncertainty band.
    Returns (shadow, gx, gy, uncertain); see shadow.py:200-233."""
    tsv_x, tsv_y, tsv_z, sin_az, cos_az = tsv
    gy = _np_gradient_axis(dem, 0)
    gx = _np_gradient_axis(dem, 1)
    tn_x = -gx / psx
    tn_y = -gy / -abs(psy)

    norm = torch.sqrt(tn_x ** 2 + tn_y ** 2 + 1.0)
    x = (tn_x * tsv_x + tn_y * tsv_y + tsv_z) / norm
    t = tn_x * sin_az + tn_y * cos_az

    low_inc = (x >= x_crit32) & (x <= 1.0)
    backslope = t <= t_crit32
    shadow = low_inc | (~backslope)

    # the f32 error of t scales with the terrain-normal magnitude, so the
    # t band widens per pixel; x is normalized, so a constant band suffices
    eps_t_px = eps_t + eps_x.new_tensor(_EPS_T_REL) * (torch.abs(tn_x)
                                                       + torch.abs(tn_y))
    uncertain = (torch.abs(x - x_crit32) <= eps_x) | \
                (torch.abs(x) >= 1.0 - eps_x) | \
                (torch.abs(t - t_crit32) <= eps_t_px)
    return shadow, gx, gy, uncertain


# copied from proteus_tpu/models/dswx/shadow.py:236-279
def _host_decide_f64(tn_x32, tn_y32, sun_azimuth_angle, sun_elevation_angle,
                     min_slope_angle, max_sun_local_inc_angle):
    """Reference-exact float64 decision from float32 terrain normals.

    Replicates the reference's dtype mix under NumPy 2 (dswx_hls.py:
    4245-4283): the normalization factor stays float32, the dot product and
    trig run in float64 (float32 array x float64 scalar promotes)."""
    tn_x = np.asarray(tn_x32, dtype=np.float32)
    tn_y = np.asarray(tn_y32, dtype=np.float32)
    tsv_x, tsv_y, tsv_z, sin_az, cos_az = _sun_vector_f64(
        sun_azimuth_angle, sun_elevation_angle)
    norm = np.sqrt(tn_x ** 2 + tn_y ** 2 + 1)  # float32, like the reference
    with np.errstate(invalid='ignore'):
        inc_deg = np.degrees(np.arccos(
            (tn_x * tsv_x + tn_y * tsv_y + tsv_z) / norm))
        dslope_deg = np.degrees(np.arctan(tn_x * sin_az + tn_y * cos_az))
    low_inc = inc_deg <= float(max_sun_local_inc_angle)
    backslope = dslope_deg <= float(min_slope_angle)
    return low_inc | (~backslope)


def _host_shadow_exact(dem, sun_azimuth_angle, sun_elevation_angle,
                       min_slope_angle, max_sun_local_inc_angle,
                       psx=30, psy=30):
    """Full host recompute with the reference's exact semantics (the path
    for float64 DEMs, and the reference the device path is held to)."""
    g = np.gradient(dem)
    tn_x = -g[1] / psx
    tn_y = -g[0] / -abs(psy)
    if dem.dtype == np.float64:
        tsv_x, tsv_y, tsv_z, sin_az, cos_az = _sun_vector_f64(
            sun_azimuth_angle, sun_elevation_angle)
        norm = np.sqrt(tn_x ** 2 + tn_y ** 2 + 1)
        with np.errstate(invalid='ignore'):
            inc_deg = np.degrees(np.arccos(
                (tn_x * tsv_x + tn_y * tsv_y + tsv_z) / norm))
            dslope_deg = np.degrees(np.arctan(
                tn_x * sin_az + tn_y * cos_az))
        low_inc = inc_deg <= float(max_sun_local_inc_angle)
        backslope = dslope_deg <= float(min_slope_angle)
        return low_inc | (~backslope)
    return _host_decide_f64(tn_x, tn_y, sun_azimuth_angle,
                            sun_elevation_angle, min_slope_angle,
                            max_sun_local_inc_angle)


def compute_opera_shadow_layer_exact(dem, sun_azimuth_angle,
                                     sun_elevation_angle, min_slope_angle,
                                     max_sun_local_inc_angle,
                                     pixel_spacing_x=30, pixel_spacing_y=30):
    """Shadow mask (True: not shadow) bit-identical to the reference
    float64 chain, as a bool tensor on ``dem``'s device.

    ``dem`` is a float32 tensor (the production case: the cubic-warped
    DEM) or a float64 tensor, which is decided on the host directly.
    """
    angles = (sun_azimuth_angle, sun_elevation_angle, min_slope_angle,
              max_sun_local_inc_angle)
    if dem.dtype == torch.float64:
        out = _host_shadow_exact(dem.cpu().numpy(), *angles,
                                 pixel_spacing_x, pixel_spacing_y)
        return torch.as_tensor(out, device=dem.device)

    x_crit, t_crit = _decision_boundaries(*angles)

    def f32(value):
        return torch.tensor(np.float32(value), device=dem.device)

    tsv32 = tuple(f32(v) for v in _sun_vector_f64(sun_azimuth_angle,
                                                  sun_elevation_angle))
    eps_t = np.float32(_EPS_T_REL * (1.0 + min(abs(t_crit), 1e30)))
    shadow, gx, gy, uncertain = _shadow_comparison_space(
        dem.to(torch.float32), tsv32, f32(x_crit), f32(t_crit),
        f32(_EPS_X), f32(eps_t), psx=pixel_spacing_x, psy=pixel_spacing_y)

    # torch.nonzero takes no static size (JAX's flatnonzero does, hence its
    # cap on the band and a whole-tile host fallback): any band size works
    sel = torch.nonzero(uncertain.reshape(-1)).reshape(-1)
    if sel.numel():
        # terrain normals by host IEEE division (reference semantics) from
        # the bit-exact device gradients
        flat_gx = gx.reshape(-1)[sel].cpu().numpy()
        flat_gy = gy.reshape(-1)[sel].cpu().numpy()
        decided = _host_decide_f64(-flat_gx / pixel_spacing_x,
                                   -flat_gy / -abs(pixel_spacing_y),
                                   *angles)
        shadow = shadow.reshape(-1)
        shadow[sel] = torch.as_tensor(decided, device=dem.device)
        shadow = shadow.reshape(dem.shape)
    return shadow
