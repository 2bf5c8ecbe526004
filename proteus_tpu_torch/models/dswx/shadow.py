"""Terrain shadow layer (SHAD) from a pre-warped DEM: the exact
'sun_local_inc_angle' algorithm and the exact 'otsu' algorithm, and the
single-pass float32 variants of both that the exact ones bracket.

Port of ``proteus_tpu/models/dswx/shadow.py``: ``:53-358`` and, for
'otsu', ``:383-734``. For 'sun_local_inc_angle' the device
decides each pixel in comparison space (the cosine of the incidence angle
against a float64-bisected boundary; likewise the tangent of the
directional slope) and flags an epsilon band of near-boundary pixels; the
host re-decides only those in float64 with the reference's dtype mix, from
the device *gradients* (subtraction and an exact x0.5, so bit-identical to
``np.gradient``). Division by a Python scalar on CUDA multiplies by the
reciprocal (up to 1 ULP off IEEE division), so the device terrain normals
only place a pixel in or out of the band; they are never handed to the
host. The result is bit-identical to the reference's float64 chain.

'otsu' (``compute_hillshade_exact`` and
``compute_otsu_shadow_layer_exact``) is GDAL's Horn hillshade followed by
the reference's Otsu threshold. The device computes the illumination in
double-double float32 (the error-free transforms of ``core/eft.py``) and
brackets GDAL's float->Byte map at v +- E, so only true near-ties go to
the host's float64 oracle; the 256-bin histogram comes back as integers,
the threshold is chosen on the host in float64 and the decision is an
integer byte comparison. None of this may be wrapped in ``torch.compile``
(a fused multiply-add breaks the error-free transforms).

``compute_opera_shadow_layer``, ``compute_hillshade`` and
``compute_otsu_shadow_layer`` are the reference's single-pass float32
variants: the decisions taken on the device with no host resolution of the
band, and the Otsu threshold of ``ops/otsu.py``. The product runs the
exact variants.

The float64 host helpers below are copied from ``proteus_tpu`` because
their module imports ``jax``; each names its source lines.
"""

import struct

import numpy as np
import torch
import torch.nn.functional as F

from proteus_tpu_torch.core.eft import two_prod, two_sum
from proteus_tpu_torch.device import to_device, to_host
from proteus_tpu_torch.ops.otsu import otsu_binarize

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


def _on(value, device):
    """``value`` as a float32 tensor on ``device``. A host scalar becomes a
    0-d tensor of its float32 rounding, filled on the device (no copy from
    the host, so no wait for the stream)."""
    if np.isscalar(value):
        return torch.full((), np.float32(value), dtype=torch.float32,
                          device=device)
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def _radians32(angle, device):
    """The angle in radians as float32 on ``device`` (shadow.py:74-78): a
    host scalar converted in float64 and rounded once, an array or tensor
    rounded to float32 and then converted."""
    if np.isscalar(angle):
        return _on(np.radians(angle), device)
    return torch.deg2rad(_on(angle, device))


def compute_opera_shadow_layer(dem, sun_azimuth_angle, sun_elevation_angle,
                               min_slope_angle, max_sun_local_inc_angle,
                               pixel_spacing_x=30, pixel_spacing_y=30):
    """Shadow mask (True: not shadow) from the sun geometry, in one float32
    pass on ``dem``'s device (shadow.py:67-104). The angles are host scalars
    or tensors.

    A pixel within a few float32 ULPs of either threshold may differ from
    the reference's float64 chain (about 1e-7 of a tile), and from JAX's
    float32 chain where the two libraries' arccos, arctan, sin and cos
    round differently; ``compute_opera_shadow_layer_exact`` decides those
    pixels on the host."""
    device = dem.device
    sun_azimuth = _radians32(sun_azimuth_angle, device)
    sun_zenith = _radians32(90.0 - sun_elevation_angle, device)

    # target-to-sun unit vector (x, y, z)
    tsv_x = torch.sin(sun_azimuth) * torch.sin(sun_zenith)
    tsv_y = torch.cos(sun_azimuth) * torch.sin(sun_zenith)
    tsv_z = torch.cos(sun_zenith)

    gy = _np_gradient_axis(dem, 0)
    gx = _np_gradient_axis(dem, 1)

    # terrain normal N = [-dh/dx, -dh/dy, 1] with respect to the DEM grid;
    # the row gradient is divided by -abs(pixel_spacing_y) (north up)
    tn_x = -gx / _on(pixel_spacing_x, device)
    tn_y = -gy / _on(-abs(pixel_spacing_y), device)

    normalization = _sqrt(tn_x * tn_x + tn_y * tn_y + 1.0)
    cos_inc = (tn_x * tsv_x + tn_y * tsv_y + tsv_z) / normalization
    sun_inc_angle_degrees = torch.rad2deg(torch.arccos(cos_inc))

    directional_slope_angle = torch.rad2deg(torch.arctan(
        tn_x * torch.sin(sun_azimuth) + tn_y * torch.cos(sun_azimuth)))

    backslope_mask = directional_slope_angle <= _on(min_slope_angle, device)
    low_sun_inc_angle_mask = (sun_inc_angle_degrees
                              <= _on(max_sun_local_inc_angle, device))
    return low_sun_inc_angle_mask | (~backslope_mask)


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


def _sqrt(x):
    """The square root of x >= 0 (NaN passes) without ``torch.sqrt``:
    within 2 ULP on the CPU (tests/test_torch_shadow.py), within 3 on
    CUDA, where rsqrtf is documented within 2 and the multiply rounds once
    more (chip_smoke.py checks it on the card). Either is far inside the
    bands that take it: the shadow's 1e-5 in x, a cosine below 1 (over 160
    ULP), and the hillshade's 1e-8 relative, which ``_dd_sqrt``'s Newton
    step reaches from either first guess. ``torch.sqrt`` on the CPU goes
    through MKL's vector math, which in some fresh processes computes one
    intra-op thread's share of its first call after other parallel work to
    about 11 bits (3e-4 relative; ``tests/shadow_suspects.py``, suspect
    'first-sqrt'): enough to move pixels across those bands. ``x *
    torch.rsqrt(x)`` runs another kernel, in which that script found no
    such error."""
    finite = (x > 0) & (x < x.new_tensor(float('inf')))
    return torch.where(finite, x * torch.rsqrt(x), x)


def _shadow_comparison_space(dem, tsv, x_crit32, t_crit32, eps_x, eps_t,
                             psx=30, psy=30):
    """Device pass: f32 comparison-space decisions + uncertainty band.
    Returns (shadow, gx, gy, uncertain); see shadow.py:200-233."""
    tsv_x, tsv_y, tsv_z, sin_az, cos_az = tsv
    gy = _np_gradient_axis(dem, 0)
    gx = _np_gradient_axis(dem, 1)
    tn_x = -gx / psx
    tn_y = -gy / -abs(psy)

    norm = _sqrt(tn_x ** 2 + tn_y ** 2 + 1.0)
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


def _exact_comparison_space(dem32, angles, psx, psy):
    """``_shadow_comparison_space`` of a float32 DEM at the exact variant's
    float64 boundaries, sun vector and bands for ``angles`` (azimuth,
    elevation, min slope, max incidence): (shadow, gx, gy, uncertain)."""
    x_crit, t_crit = _decision_boundaries(*angles)

    def f32(value):
        return torch.tensor(np.float32(value), device=dem32.device)

    tsv32 = tuple(f32(v) for v in _sun_vector_f64(*angles[:2]))
    eps_t = np.float32(_EPS_T_REL * (1.0 + min(abs(t_crit), 1e30)))
    return _shadow_comparison_space(
        dem32, tsv32, f32(x_crit), f32(t_crit), f32(_EPS_X), f32(eps_t),
        psx=psx, psy=psy)


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
        out = _host_shadow_exact(to_host(dem, 'shadow_host'), *angles,
                                 pixel_spacing_x, pixel_spacing_y)
        return to_device(out, dem.device, 'shadow_host')

    shadow, gx, gy, uncertain = _exact_comparison_space(
        dem.to(torch.float32), angles, pixel_spacing_x, pixel_spacing_y)

    # torch.nonzero takes no static size (JAX's flatnonzero does, hence its
    # cap on the band and a whole-tile host fallback): any band size works
    sel = torch.nonzero(uncertain.reshape(-1)).reshape(-1)
    if sel.numel():
        # terrain normals by host IEEE division (reference semantics) from
        # the bit-exact device gradients
        flat_gx = to_host(gx.reshape(-1)[sel], 'shadow_uncertain')
        flat_gy = to_host(gy.reshape(-1)[sel], 'shadow_uncertain')
        decided = _host_decide_f64(-flat_gx / pixel_spacing_x,
                                   -flat_gy / -abs(pixel_spacing_y),
                                   *angles)
        shadow = shadow.reshape(-1)
        shadow[sel] = to_device(decided, dem.device, 'shadow_decided')
        shadow = shadow.reshape(dem.shape)
    return shadow


# ---------------------------------------------------------------------------
# GDAL-semantics hillshade (the reference's 'otsu' shadow branch)
# ---------------------------------------------------------------------------
#
# gdal.DEMProcessing("hillshade", Horn, no -compute_edges), as
# proteus_tpu/models/dswx/shadow.py:361-381 sets it out: 3x3 windows read at
# float32, the algebra in C double, byte = trunc(float32(v) + 0.5f) with
# v = 1 + 254 * cang (1 where cang <= 0) clamped at 255, and the 1 px border
# ring filled with the nodata value 0 (which enters the Otsu histogram).


# copied from proteus_tpu/models/dswx/shadow.py:386-443
def _hillshade_consts_f64(sun_azimuth_angle, sun_elevation_angle):
    alt = np.radians(np.float64(sun_elevation_angle))
    az = np.radians(np.float64(sun_azimuth_angle))
    return (np.sin(alt), np.cos(az) * np.cos(alt),
            np.sin(az) * np.cos(alt))


def _hillshade_windows_np(z):
    """The 9 shifted 3x3-window views of a replicate-padded host array
    (only interior pixels are consumed; the border ring is overwritten
    with the GDAL edge nodata 0)."""
    p = np.pad(z, 1, mode='edge')
    return {(dy, dx): p[dy:dy + z.shape[0], dx:dx + z.shape[1]]
            for dy in (0, 1, 2) for dx in (0, 1, 2)}


def _hillshade_bytes_f64(w, sun_azimuth_angle, sun_elevation_angle,
                         pixel_spacing_x, pixel_spacing_y):
    """Float64 hillshade bytes from float32 3x3 window values.

    ``w`` maps (dy, dx) -> float32 arrays (any common shape). This is
    THE oracle the device path is bit-identical to."""
    sin_alt, cos_az_cos_alt, sin_az_cos_alt = _hillshade_consts_f64(
        sun_azimuth_angle, sun_elevation_angle)
    wd = {k: np.asarray(v, dtype=np.float64) for k, v in w.items()}
    x = ((wd[(0, 0)] + 2.0 * wd[(1, 0)] + wd[(2, 0)])
         - (wd[(0, 2)] + 2.0 * wd[(1, 2)] + wd[(2, 2)])) \
        / (8.0 * float(pixel_spacing_x))
    y = ((wd[(2, 0)] + 2.0 * wd[(2, 1)] + wd[(2, 2)])
         - (wd[(0, 0)] + 2.0 * wd[(0, 1)] + wd[(0, 2)])) \
        / (8.0 * float(pixel_spacing_y))
    num = sin_alt - (y * cos_az_cos_alt - x * sin_az_cos_alt)
    with np.errstate(invalid='ignore', over='ignore'):
        cang = num / np.sqrt(1.0 + x * x + y * y)
        v = np.where(num <= 0.0, 1.0, 1.0 + 254.0 * cang)
    f = v.astype(np.float32)
    with np.errstate(invalid='ignore'):
        out = np.where(f >= np.float32(255.0), np.float32(255.0),
                       np.trunc(f + np.float32(0.5)))
        # NaN windows: GDAL's float->Byte cast of NaN lands on 0 in
        # practice (x86/ARM float->int of NaN); pinned deterministically
        out = np.where(np.isnan(f), np.float32(0.0), out)
    return out.astype(np.uint8)


def _host_hillshade_gdal(dem32, sun_azimuth_angle, sun_elevation_angle,
                         pixel_spacing_x, pixel_spacing_y):
    """Full-array host oracle: float64 algebra + the border nodata
    ring."""
    z = np.asarray(dem32, dtype=np.float32)
    out = _hillshade_bytes_f64(_hillshade_windows_np(z),
                               sun_azimuth_angle, sun_elevation_angle,
                               pixel_spacing_x, pixel_spacing_y)
    out[0, :] = 0
    out[-1, :] = 0
    out[:, 0] = 0
    out[:, -1] = 0
    return out


# -- double-double float32 helpers (shadow.py:453-484). A pair (hi, lo) of
#    float32 tensors stands for hi + lo. PyTorch's tensor-by-tensor division
#    is correctly rounded on the CPU and on CUDA; the square root's first
#    guess, ``_sqrt``, is within 2 ULP on the CPU and 3 on CUDA. One Newton
#    refinement against an exact dd residual gives full dd accuracy either
#    way. Every operand is a tensor: a Python float in a ``/`` would turn
#    into a multiply by its reciprocal on CUDA.


def _dd_add(a, b):
    sh, se = two_sum(a[0], b[0])
    return two_sum(sh, se + (a[1] + b[1]))


def _dd_neg(a):
    return (-a[0], -a[1])


def _dd_mul(a, b):
    ph, pe = two_prod(a[0], b[0])
    return two_sum(ph, pe + (a[0] * b[1] + a[1] * b[0]))


def _dd_div(a, b):
    q0 = a[0] / b[0]
    r = _dd_add(a, _dd_neg(_dd_mul((q0, torch.zeros_like(q0)), b)))
    return two_sum(q0, (r[0] + r[1]) / b[0])


def _dd_sqrt(a):
    s0 = _sqrt(a[0])
    t = two_prod(s0, s0)
    r = _dd_add(a, (-t[0], -t[1]))
    c = (r[0] + r[1]) / (s0 + s0)
    return two_sum(s0, torch.where(a[0] > 0, c, torch.zeros_like(c)))


def _dd_const(x):
    """Host split of a float64 constant into an f32 (hi, lo) pair."""
    hi = np.float32(x)
    return hi, np.float32(np.float64(x) - np.float64(hi))


def _hs_byte_map(f):
    """GDAL's float->Byte composite map in exact-IEEE f32 ops:
    trunc(fl32(f + 0.5f)) clamped at 255, NaN -> 0 (matches the
    oracle's GDALCopyWord semantics)."""
    b = torch.where(f >= 255.0, f.new_tensor(255.0),
                    torch.trunc(f + f.new_tensor(0.5)))
    return torch.where(torch.isnan(f), f.new_tensor(0.0), b)


def _hillshade_consts_dd(sun_azimuth_angle, sun_elevation_angle):
    """Host split of the three f64 illumination constants into a (6,)
    float32 numpy array of (hi, lo) pairs."""
    return np.array(
        [part for c in _hillshade_consts_f64(sun_azimuth_angle,
                                             sun_elevation_angle)
         for part in _dd_const(c)], dtype=np.float32)


def _windows(z):
    """The 9 shifted 3x3-window views of the replicate-padded tensor."""
    p = F.pad(z[None, None], (1, 1, 1, 1), mode='replicate')[0, 0]
    h, w = z.shape
    return {(dy, dx): p[dy:dy + h, dx:dx + w]
            for dy in (0, 1, 2) for dx in (0, 1, 2)}


def _hillshade_comparison_space(dem, consts_dd, psx, psy):
    """Device pass: hillshade bytes (uint8) and the uncertainty band
    (bool) against the f64 oracle, computed in double-double f32
    (shadow.py:505-597).

    The oracle's f64 Horn sums are exact, so it deviates from exact real
    arithmetic only by its division, sqrt and downstream roundings (~1e-15
    rel). The dd chain tracks exact arithmetic to ~1e-12 rel, so GDAL's
    float->Byte map evaluated at v +- E (E covering both chains' error
    with >1000x margin) brackets the oracle's byte: pixels where the two
    endpoint bytes agree are proven, the rest go to the host."""
    z = dem.to(torch.float32)
    zero = torch.zeros_like(z)
    w = _windows(z)

    def const(value):
        return z.new_tensor(np.float32(value))

    def dd(hi):
        return (hi, torch.zeros_like(hi))

    def dd_const(pair):
        return (const(pair[0]) + zero, const(pair[1]) + zero)

    def horn_sum(a, b, c):
        # a + 2b + c exactly (2b is exact in f32 barring overflow)
        return _dd_add(two_sum(a, c), dd(b + b))

    # x = (left - right) / (8 * psx): the oracle divides by the f64
    # constant; multiplying by its dd reciprocal is equivalent to within
    # ~2^-44 rel, 5 orders inside the E margin
    inv8psx = dd_const(_dd_const(1.0 / (8.0 * float(psx))))
    inv8psy = dd_const(_dd_const(1.0 / (8.0 * float(psy))))
    a_l = horn_sum(w[(0, 0)], w[(1, 0)], w[(2, 0)])
    a_r = horn_sum(w[(0, 2)], w[(1, 2)], w[(2, 2)])
    b_b = horn_sum(w[(2, 0)], w[(2, 1)], w[(2, 2)])
    b_t = horn_sum(w[(0, 0)], w[(0, 1)], w[(0, 2)])
    x = _dd_mul(_dd_add(a_l, _dd_neg(a_r)), inv8psx)
    y = _dd_mul(_dd_add(b_b, _dd_neg(b_t)), inv8psy)
    del a_l, a_r, b_b, b_t

    consts = np.asarray(consts_dd, dtype=np.float32)
    c_sin = dd_const(consts[0:2])
    c_cos = dd_const(consts[2:4])
    c_saz = dd_const(consts[4:6])
    one = const(1.0) + zero
    term = _dd_add(_dd_mul(y, c_cos), _dd_neg(_dd_mul(x, c_saz)))
    num = _dd_add(c_sin, _dd_neg(term))
    den = _dd_sqrt(_dd_add(_dd_add(dd(one), _dd_mul(x, x)), _dd_mul(y, y)))
    cang = _dd_div(num, den)
    v = _dd_add(dd(one), _dd_mul(cang, dd(const(254.0) + zero)))
    # num <= 0 -> v = 1 (the oracle tests its f64 num; a sign flip within
    # ~2^-44 rel cannot move the byte, v is continuous at num = 0)
    is_dark = (num[0] < 0) | ((num[0] == 0) & (num[1] <= 0))
    vh = torch.where(is_dark, const(1.0), v[0])
    vl = torch.where(is_dark, const(0.0), v[1])
    del x, y, term, num, den, cang, v

    maxw = zero
    win_finite = torch.ones_like(z, dtype=torch.bool)
    for wa in w.values():
        maxw = torch.maximum(maxw, torch.abs(wa))
        win_finite &= torch.isfinite(wa)

    # E: the dd chain's error and the oracle's own f64 rounding, both with
    # >1000x margin; the magnitude term also flags finite windows whose
    # f32/dd intermediates overflowed
    inv_minps = 1.0 / min(abs(float(psx)), abs(float(psy)))
    err = (const(1e-8) * (torch.abs(vh) + const(1.0))
           + const(2.0 ** -26 * inv_minps) * maxw + const(1e-10))

    lo = two_sum(vh, vl - err)[0]
    hi = two_sum(vh, vl + err)[0]
    byte = _hs_byte_map(vh)
    uncertain = (_hs_byte_map(lo) != _hs_byte_map(hi)) & win_finite
    # finite windows whose dd value itself went nonfinite (sum overflow):
    # the oracle is finite there, always resolve on the host
    uncertain |= win_finite & ~torch.isfinite(vh)

    # GDAL edge ring (no computeEdges): dst nodata 0, never uncertain
    byte[0, :] = 0
    byte[-1, :] = 0
    byte[:, 0] = 0
    byte[:, -1] = 0
    uncertain[0, :] = False
    uncertain[-1, :] = False
    uncertain[:, 0] = False
    uncertain[:, -1] = False
    return byte.to(torch.uint8), uncertain


def compute_hillshade_exact(dem, sun_azimuth_angle, sun_elevation_angle,
                            pixel_spacing_x=30.0, pixel_spacing_y=-30.0,
                            return_band=False):
    """Hillshade bytes (a uint8 tensor on ``dem``'s device) bit-identical
    to the float64 GDAL-semantics oracle ``_host_hillshade_gdal``,
    computed on the device in float32 with the host's float64 resolution
    of the uncertainty band (shadow.py:600-657). With ``return_band`` also
    the number of pixels the host decided.

    ``torch.nonzero`` takes no static size, so JAX's two index sizes and
    its whole-tile host fallback above 131072 pixels have no counterpart:
    one count, one index fetch, any band size."""
    dem32 = dem.to(torch.float32)
    byte, uncertain = _hillshade_comparison_space(
        dem32, _hillshade_consts_dd(sun_azimuth_angle, sun_elevation_angle),
        float(pixel_spacing_x), float(pixel_spacing_y))
    sel = torch.nonzero(uncertain.reshape(-1)).reshape(-1)
    n_band = int(sel.numel())
    if n_band:
        # the flagged pixels' 3x3 float32 windows, one small fetch
        vals = to_host(torch.stack([wa.reshape(-1)[sel] for wa in
                                    _windows(dem32).values()]),
                       'shadow_uncertain')
        wsel = {(dy, dx): vals[dy * 3 + dx]
                for dy in (0, 1, 2) for dx in (0, 1, 2)}
        decided = _hillshade_bytes_f64(wsel, sun_azimuth_angle,
                                       sun_elevation_angle,
                                       pixel_spacing_x, pixel_spacing_y)
        byte = byte.reshape(-1)
        byte[sel] = to_device(decided, dem.device, 'shadow_decided')
        byte = byte.reshape(dem.shape)
    return (byte, n_band) if return_band else byte


# copied from proteus_tpu/models/dswx/shadow.py:660-686
def _otsu_threshold_f64(value_counts):
    """The reference's Otsu threshold (dswx_hls.py:1638-1684) in
    float64 from a 256-entry BYTE-VALUE histogram (a sufficient
    statistic for a uint8 image): np.histogram's own binning over
    [min, max] via its weights path, then the cumulative inter-class
    variance argmax (NaN entries propagate through np.argmax exactly as
    in the reference)."""
    counts = np.asarray(value_counts, dtype=np.int64)
    present = np.flatnonzero(counts)
    if present.size == 0:
        return None
    values = present.astype(np.float64)
    hist, bin_edges = np.histogram(values, bins=256,
                                   weights=counts[present].astype(
                                       np.float64))
    hist = np.divide(hist.ravel(), hist.max())
    bin_mids = (bin_edges[:-1] + bin_edges[1:]) / 2.
    weight1 = np.cumsum(hist)
    weight2 = np.cumsum(hist[::-1])[::-1]
    with np.errstate(invalid='ignore', divide='ignore'):
        mean1 = np.cumsum(hist * bin_mids) / weight1
        mean2 = (np.cumsum((hist * bin_mids)[::-1])
                 / weight2[::-1])[::-1]
        inter_class_variance = (weight1[:-1] * weight2[1:]
                                * (mean1[:-1] - mean2[1:]) ** 2)
    index_of_max_val = np.argmax(inter_class_variance)
    return float(bin_mids[:-1][index_of_max_val])


def compute_otsu_shadow_layer_exact(dem, sun_azimuth_angle,
                                    sun_elevation_angle,
                                    pixel_spacing_x=30.0,
                                    pixel_spacing_y=-30.0):
    """The otsu shadow mask (True: not shadow), a bool tensor on ``dem``'s
    device, bit-identical to the reference's float64 chain given this
    module's hillshade oracle (shadow.py:689-712): exact hillshade bytes,
    their 256-bin histogram fetched as integers (``torch.bincount``:
    integer atomics on CUDA, so deterministic), the threshold chosen on
    the host in float64 by the reference's formula, and ``hillshade >
    threshold`` as an integer byte comparison."""
    hs = compute_hillshade_exact(dem, sun_azimuth_angle,
                                 sun_elevation_angle, pixel_spacing_x,
                                 pixel_spacing_y)
    counts = torch.bincount(hs.reshape(-1).long(), minlength=256)
    threshold = _otsu_threshold_f64(counts.cpu().numpy())
    # byte > float64 threshold  <=>  byte >= cut (exact: bytes are ints)
    over = np.arange(256, dtype=np.float64) > threshold
    cut = int(np.argmax(over)) if over.any() else 256
    if cut >= 256:
        return torch.zeros(hs.shape, dtype=torch.bool, device=hs.device)
    return hs >= cut


def compute_hillshade(dem, sun_azimuth_angle, sun_elevation_angle,
                      pixel_spacing_x=30.0, pixel_spacing_y=-30.0):
    """GDAL gdaldem hillshade (Horn kernel) as uint8 bytes on ``dem``'s
    device: the border ring 0 (no computeEdges), the interior 1..255
    (shadow.py:715-725). The single-pass variant: the double-double
    float32 bytes with no host resolution of the uncertainty band, so a
    byte may differ from the float64 oracle where that band is set
    (``compute_hillshade_exact`` decides those pixels on the host)."""
    byte, _ = _hillshade_comparison_space(
        dem.to(torch.float32),
        _hillshade_consts_dd(sun_azimuth_angle, sun_elevation_angle),
        float(pixel_spacing_x), float(pixel_spacing_y))
    return byte


def compute_otsu_shadow_layer(dem, sun_azimuth_angle, sun_elevation_angle,
                              pixel_spacing_x=30.0, pixel_spacing_y=-30.0):
    """Hillshade and Otsu binarization (True: not shadow), the single-pass
    float32 variant, all of it on ``dem``'s device (shadow.py:728-734)."""
    hs = compute_hillshade(dem, sun_azimuth_angle, sun_elevation_angle,
                           pixel_spacing_x, pixel_spacing_y)
    return otsu_binarize(hs)
