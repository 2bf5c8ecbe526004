"""Warp-as-gather on the device: reproject ancillary rasters onto the
product grid.

Port of the device half of ``proteus_tpu/geo/warp.py:463-945``
(``_device_resample_impl`` and ``warp_to_grid_device``). The host half
(``SourceRaster``, ``GridTransformer``, ``_resolve_window``,
``_auto_grid_spacing``, ``_dd_split``, ``_resample_block``,
``warp_to_grid``) is imported from ``proteus_tpu.geo.warp`` (through
``proteus_tpu_torch.host``), not copied.

The source-coordinate lattice is interpolated in double-float32
error-free transforms (``proteus_tpu_torch.core.eft``); cubic and bilinear
kernels accumulate in double-float32 too. Every pixel whose device value
sits inside the ambiguity band of a floor, a tap selection or an f32
rounding boundary is re-evaluated on the host with the float64 pipeline
of ``warp_to_grid``, so the result is bit-identical to the host warp.
"""

import numpy as np
import torch

from proteus_tpu_torch.core.eft import f32, two_prod, two_sum
from proteus_tpu_torch.host import (CRS, _KERNEL_RADIUS, GridTransformer,
                                    SourceRaster, _auto_grid_spacing,
                                    _dd_split, _resample_block,
                                    _resolve_window, transform_points,
                                    warp_to_grid)


def torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, dtype=np_dtype)).dtype


def _dd_norm(hi, lo):
    s = hi + lo
    return s, lo - (s - hi)


def _dd_add(ah, al, bh, bl):
    s, e = two_sum(ah, bh)
    return _dd_norm(s, e + (al + bl))


def _dd_mul_f32(ah, al, f):
    p, e = two_prod(ah, f)
    return _dd_norm(p, e + al * f)


def _dd_mul(x, y):
    p, e = two_prod(x[0], y[0])
    return _dd_norm(p, e + (x[0] * y[1] + x[1] * y[0]))


def _dd_lerp(g0, g1, f):
    """g0 + (g1 - g0) * f in double-float32; g0/g1 are (hi, lo)."""
    dh, dl = _dd_add(g1[0], g1[1], -g0[0], -g0[1])
    mh, ml = _dd_mul_f32(dh, dl, f)
    return _dd_add(g0[0], g0[1], mh, ml)


def _dd_floor(hi, err):
    """Exact floor of the double-float32 value hi + err, with its
    fraction as a (hi, lo) pair (warp.py:594-613)."""
    base = torch.floor(hi)
    frac, frac_err = two_sum(hi, -base)
    c, cl = two_sum(frac, frac_err + err)
    one, zero = f32(1.0, hi), f32(0.0, hi)
    shift = torch.where(c < 0, one, torch.where(c >= 1, -one, zero))
    cf, cl = _dd_add(c, cl, shift, zero)
    return (base - shift).to(torch.int32), cf, cl


def _near_edge(hi, cf):
    """cf within the dd-vs-f64 divergence of a floor boundary."""
    eps = f32(2.0 ** -22, hi) + (torch.abs(hi) + f32(16.0, hi)) \
        * f32(2.0 ** -38, hi)
    return (cf < eps) | (cf > 1 - eps)


def device_resample(data, valid, lat, spacing, out_h, out_w, algorithm,
                    fill, wraps=False, full_width=None):
    """On-device warp of ``data`` (a 2-D tensor) onto the (out_h, out_w)
    grid; returns (out, ambiguous).

    ``lat`` is (u_hi, u_lo, v_hi, v_lo): the window-relative source pixel
    coordinates of the float64 lattice as double-float32 tensors.
    ``valid`` is None or a bool tensor of data's shape.
    """
    h, w = data.shape
    gh, gw = lat[0].shape
    if spacing & (spacing - 1):
        raise ValueError(f'grid_spacing must be a power of two for the '
                         f'device warp (got {spacing})')
    dev = data.device
    u_hi, u_lo, v_hi, v_lo = lat
    c = (lambda value: f32(value, u_hi))

    # spacing is a power of two: i/spacing and the lattice weights are
    # exact in f32 and equal to the host's float64 values
    inv = c(1.0 / spacing)
    fi = torch.arange(out_h, dtype=torch.float32, device=dev) * inv
    fj = torch.arange(out_w, dtype=torch.float32, device=dev) * inv
    i0 = torch.floor(fi).to(torch.int64).clamp(0, gh - 2)
    j0 = torch.floor(fj).to(torch.int64).clamp(0, gw - 2)
    wi = (fi - i0.to(torch.float32))[:, None]
    wj = (fj - j0.to(torch.float32))[None, :]

    def interp(g_hi, g_lo):
        rows = _dd_lerp((g_hi[i0], g_lo[i0]), (g_hi[i0 + 1], g_lo[i0 + 1]),
                        wi)
        return _dd_lerp((rows[0][:, j0], rows[1][:, j0]),
                        (rows[0][:, j0 + 1], rows[1][:, j0 + 1]), wj)

    u, u_err = interp(u_hi, u_lo)
    v, v_err = interp(v_hi, v_lo)

    dflat = data.reshape(-1)
    vflat = valid.reshape(-1) if valid is not None else None

    def gather(rows, cols):
        rows = rows.to(torch.int64)
        cols = cols.to(torch.int64)
        if wraps:
            cols = torch.remainder(cols, full_width)
        inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
        flat = rows.clamp(0, h - 1) * w + cols.clamp(0, w - 1)
        vals = dflat[flat]
        ok = inb if vflat is None else (inb & vflat[flat])
        return vals, ok

    if algorithm == 'nearest':
        rows, fv_n, _ = _dd_floor(v, v_err)
        cols, fu_n, _ = _dd_floor(u, u_err)
        amb = _near_edge(u, fu_n) | _near_edge(v, fv_n)
        # a floor flip far outside the source window cannot change the
        # (fill) result; wrapping sources take any u, so only rows bound
        in_range = (v >= -1) & (v <= h + 1)
        if not wraps:
            in_range = in_range & (u >= -1) & (u <= w + 1)
        vals, ok = gather(rows, cols)
        fill_t = torch.tensor(fill, dtype=data.dtype, device=dev)
        return torch.where(ok, vals, fill_t), amb & in_range

    # --- kernel resamplers in double-f32 (warp.py:641-797) ---
    zero = c(0.0)

    def dd_addc(x, value):
        return _dd_add(x[0], x[1], c(value), zero)

    def dd_mulc(x, value):
        return _dd_mul_f32(x[0], x[1], c(value))

    def const_minus(value, x):
        return _dd_add(c(value), zero, -x[0], -x[1])

    uc = _dd_add(u, u_err, c(-0.5), zero)
    vc = _dd_add(v, v_err, c(-0.5), zero)
    iu, fu_hi, fu_lo = _dd_floor(uc[0], uc[1])
    iv, fv_hi, fv_lo = _dd_floor(vc[0], vc[1])
    amb = _near_edge(uc[0], fu_hi) | _near_edge(vc[0], fv_hi)
    fu = (fu_hi, fu_lo)
    fv = (fv_hi, fv_lo)

    if algorithm == 'bilinear':
        taps = [(0, const_minus(1.0, fv)), (1, fv)]
        cols_w = [(0, const_minus(1.0, fu)), (1, fu)]
    else:
        # GDAL cubic (a=-0.5): |x|<=1: 1.5x^3-2.5x^2+1;
        # 1<|x|<2: -0.5x^3+2.5x^2-4x+2, per tap on f+1, f, 1-f, 2-f
        def poly_inner(x):
            t = dd_addc(dd_mulc(x, 1.5), -2.5)
            t = _dd_mul(t, x)
            t = _dd_mul(t, x)
            return dd_addc(t, 1.0)

        def poly_outer(x):
            t = dd_addc(dd_mulc(x, -0.5), 2.5)
            t = _dd_mul(t, x)
            t = dd_addc(t, -4.0)
            t = _dd_mul(t, x)
            return dd_addc(t, 2.0)

        def cubic(f):
            return [(-1, poly_outer(dd_addc(f, 1.0))),
                    (0, poly_inner(f)),
                    (1, poly_inner(const_minus(1.0, f))),
                    (2, poly_outer(const_minus(2.0, f)))]
        taps = cubic(fv)
        cols_w = cubic(fu)

    # accumulation modes mirroring _resample_block: fast (no nodata, no
    # wrap: full-weight taps, no renormalization), unmasked wrap (full
    # weight + division), masked (validity-weighted taps + division)
    if wraps:
        center_in = (v >= 0) & (v <= h)
    else:
        center_in = (u >= 0) & (u <= w) & (v >= 0) & (v <= h)
    zeros = torch.zeros(u.shape, dtype=torch.float32, device=dev)
    fast = valid is None and not wraps
    unmasked = valid is None
    acc = (zeros, zeros)
    wacc = (zeros, zeros)
    macc = zeros  # magnitude accumulator: bounds the dd-vs-f64 error
    inf = c(float('inf'))
    vmin = torch.full(u.shape, float('inf'), dtype=torch.float32,
                      device=dev)
    vmax = -vmin
    for dr, wr in taps:
        for dc, wc in cols_w:
            vals, ok = gather(iv + dr, iu + dc)
            vf = vals.to(torch.float32)
            w2 = _dd_mul(wr, wc)
            term = _dd_mul_f32(w2[0], w2[1], vf)
            if unmasked:
                macc = macc + torch.abs(term[0])
                vmin = torch.minimum(vmin, vf)
                vmax = torch.maximum(vmax, vf)
                acc = _dd_add(acc[0], acc[1], term[0], term[1])
                if not fast:
                    wacc = _dd_add(wacc[0], wacc[1], w2[0], w2[1])
            else:
                # a NaN (nodata) tap would poison the error trackers
                macc = macc + torch.where(ok, torch.abs(term[0]), zero)
                vmin = torch.minimum(vmin, torch.where(ok, vf, inf))
                vmax = torch.maximum(vmax, torch.where(ok, vf, -inf))
                acc = _dd_add(acc[0], acc[1],
                              torch.where(ok, term[0], zero),
                              torch.where(ok, term[1], zero))
                wacc = _dd_add(wacc[0], wacc[1],
                               torch.where(ok, w2[0], zero),
                               torch.where(ok, w2[1], zero))

    if fast:
        res_hi, res_lo = acc
        good = center_in
        err_scale = c(1.0)
    else:
        # dd division: one Newton correction on the f32 quotient (tensor
        # by tensor division is correctly rounded IEEE on CPU and CUDA)
        denom = torch.where(wacc[0] > c(1e-9), wacc[0], c(1.0))
        q0 = acc[0] / denom
        ph, pl = _dd_mul_f32(wacc[0], wacc[1], q0)
        r = _dd_add(acc[0], acc[1], -ph, -pl)
        res_hi, res_lo = _dd_norm(*two_sum(q0, r[0] / denom))
        good = center_in & (wacc[0] > c(1e-9))
        amb = amb | (torch.abs(wacc[0] - c(1e-9)) < c(1e-12))
        err_scale = c(1.0) / torch.maximum(torch.abs(denom), c(2.0 ** -8))
        # below the clamp the 1/wacc amplification outruns any band
        amb = amb | (good & (torch.abs(wacc[0]) < c(2.0 ** -8)))

    # the f64 value rounds to another f32 than hi only when |lo| sits
    # within the dd-vs-f64 error of ulp(hi)/2 (warp.py:748-773)
    absh = torch.abs(res_hi) + c(1e-30)
    half_ulp = (torch.nextafter(absh, inf) - absh) * c(0.5)
    coord_mag = torch.abs(uc[0]) + torch.abs(vc[0]) + c(32.0)
    spread = torch.nan_to_num(vmax - vmin, nan=0.0, posinf=0.0,
                              neginf=0.0)
    delta = half_ulp * c(2.0 ** -16) \
        + err_scale * (macc * c(2.0 ** -40)
                       + spread * coord_mag * c(2.0 ** -42))
    amb = amb | (torch.abs(torch.abs(res_lo) - half_ulp) < delta)
    out = torch.where(good, res_hi, c(fill))
    return out, amb & center_in


def warp_to_grid_device(input_file, geotransform, projection, length,
                        width, resample_algorithm='nearest',
                        margin_in_pixels=0, grid_spacing=None, dtype=None,
                        device=None):
    """``warp_to_grid`` with the interpolation and gather on ``device``.

    Returns a tensor on ``device``, bit-identical to the host
    ``proteus_tpu.geo.warp.warp_to_grid`` for every resampler.
    """
    if device is None:
        raise ValueError('warp_to_grid_device: device is required')
    if resample_algorithm == 'average':
        # footprint-based kernel with data-dependent tap counts: the host
        # float64 implementation, as in the counterpart
        out = warp_to_grid(input_file, geotransform, projection, length,
                           width, resample_algorithm='average',
                           margin_in_pixels=margin_in_pixels,
                           grid_spacing=grid_spacing, dtype=dtype)
        return torch.as_tensor(out, device=device)

    m = margin_in_pixels
    x0, dx, _, y0, _, dy = geotransform
    tx0 = x0 - m * dx
    ty0 = y0 - m * dy
    out_h = length + 2 * m
    out_w = width + 2 * m
    tile_crs = CRS.from_any(projection)
    if grid_spacing is None:
        grid_spacing = _auto_grid_spacing(tile_crs, dx)

    src = SourceRaster(input_file)
    try:
        radius = _KERNEL_RADIUS[resample_algorithm]
        bj = np.linspace(0, out_w, 256)
        bi = np.linspace(0, out_h, 256)
        ej = np.concatenate([bj, bj, np.zeros_like(bi),
                             np.full_like(bi, out_w)])
        ei = np.concatenate([np.zeros_like(bj), np.full_like(bj, out_h),
                             bi, bi])
        sx, sy = transform_points(tile_crs, src.crs, tx0 + ej * dx,
                                  ty0 + ei * dy)
        eu, ev = src.pixel_coords(sx, sy)
        r0, c0, wh, ww = _resolve_window(src, eu, ev, radius)
        nodata = src.nodata
        fill = nodata if nodata is not None else 0
        out_dtype = np.dtype(dtype or src.reader.dtype)
        if wh == 0 or ww == 0:
            return torch.full((out_h, out_w), fill,
                              dtype=torch_dtype(out_dtype), device=device)

        data = src.reader.read(window=(r0, c0, wh, ww))
        if data.ndim == 3:
            data = data[:, :, 0]

        # float64 lattice of window-relative source pixel coordinates,
        # continuous across the antimeridian (the gather wraps per pixel)
        tx = GridTransformer(tile_crs, src.crs, tx0, ty0, dx, dy, out_h,
                             out_w, spacing=grid_spacing)
        sx0, sdx, _, sy0, _, sdy = src.gt
        u_hi, u_lo = _dd_split((tx.sx - sx0) / sdx - c0)
        v_hi, v_lo = _dd_split((tx.sy - sy0) / sdy - r0)
        lat = tuple(torch.as_tensor(a, device=device)
                    for a in (u_hi, u_lo, v_hi, v_lo))
        wraps = src.wraps and c0 == 0 and ww == src.width

        if nodata is not None and np.isnan(nodata):
            valid = ~np.isnan(data.astype(np.float64))
        elif nodata is not None:
            valid = data != nodata
        else:
            valid = None

        is_float_fill = isinstance(fill, float) and np.isnan(fill)
        kernel_input = data if resample_algorithm == 'nearest' else \
            data.astype(np.float32)
        all_valid = valid is None or bool(valid.all())
        out, amb = device_resample(
            torch.as_tensor(np.ascontiguousarray(kernel_input),
                            device=device),
            None if all_valid else torch.as_tensor(valid, device=device),
            lat, grid_spacing, out_h, out_w, resample_algorithm,
            float(fill) if (is_float_fill or
                            resample_algorithm != 'nearest') else fill,
            wraps=wraps, full_width=ww)
        to_int = out_dtype.kind in 'ui' and out.dtype.is_floating_point
        if to_int and radius > 0:
            # kernel value near a half-integer: the f32 intermediate can
            # round differently than the host's float64
            half_dist = torch.abs(out - torch.floor(out) - 0.5)
            amb = amb | (torch.isfinite(out) & (half_dist < 1e-4))
        if to_int:
            info = np.iinfo(out_dtype)
            out = torch.clamp(torch.round(out), info.min, info.max)
        flat = torch.nonzero(amb.reshape(-1)).reshape(-1)
        if flat.numel():
            # float64 host re-evaluation of the ambiguous pixels,
            # replicating warp_to_grid's chunk pipeline (warp.py:911-942)
            flat_np = flat.cpu().numpy()
            ii = (flat_np // out_w).astype(np.float64)
            jj = (flat_np % out_w).astype(np.float64)
            hsx, hsy = tx(ii, jj)
            hu, hv = src.pixel_coords(hsx, hsy)
            hu = hu - c0
            hv = hv - r0
            rlo = max(int(np.floor(np.nanmin(hv))) - 4, 0)
            rhi = min(int(np.ceil(np.nanmax(hv))) + 5, data.shape[0])
            rlo = min(rlo, data.shape[0] - 1)
            rhi = max(rhi, rlo + 1)
            valid_slice = None if valid is None else valid[rlo:rhi]
            res = _resample_block(
                data[rlo:rhi].astype(np.float64), valid_slice,
                hu, hv - rlo, resample_algorithm, fill, wraps=wraps,
                width=ww, all_valid=all_valid)
            if to_int:
                res = np.clip(np.rint(res), np.iinfo(out_dtype).min,
                              np.iinfo(out_dtype).max)
            out = out.reshape(-1)
            out[flat] = torch.as_tensor(res, device=device).to(out.dtype)
            out = out.reshape(out_h, out_w)
        return out.to(torch_dtype(out_dtype))
    finally:
        src.close()
