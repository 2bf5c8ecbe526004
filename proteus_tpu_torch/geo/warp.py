"""Warp-as-gather: reproject ancillary rasters onto the product grid.

Port of ``proteus_tpu/geo/warp.py``. The host half (``SourceRaster``,
``GridTransformer``, ``_resolve_window``, ``_auto_grid_spacing``,
``warp_to_grid``, ``_resample_block``, ``_dd_split``,
``worldcover_year_of``) is copied from :27-470 and :948-977: every target
pixel center is inverse-projected to the source CRS with the exact float64
engine of ``proteus_tpu_torch.geo.crs``, and the source raster is sampled
with the requested kernel (nearest / bilinear / cubic with GDAL's a=-0.5
weights, average) honoring the source nodata.

The device half (``device_resample``, ``warp_to_grid_device``) ports
:463-945. The source-coordinate lattice is interpolated in double-float32
error-free transforms (``proteus_tpu_torch.core.eft``); cubic and bilinear
kernels accumulate in double-float32 too. On a card the resampler is the
CUDA kernel of ``ops/warp_kernel.py``, which writes only the output and
the ambiguity flags; ``device_resample_plain`` is its eager twin. Every
pixel whose device value sits inside the ambiguity band of a floor, a tap
selection or an f32 rounding boundary is re-evaluated on the host with
the float64 pipeline of ``warp_to_grid``, so the result is bit-identical
to the host warp.

The host halves of both warps are stages (``STAGE_TIMES.stage``: a
tracer span, and a row of the campaign's stage table when it is on):
``warp.read`` (the source window worked out and read), ``warp.lattice``
(the coordinate lattice; on the device path also its double-float split
and its copy to the device), ``warp.source`` (the validity mask, the
source's cast where one is needed and, on the device path, its copy)
and ``warp.redecide`` (the float64 re-evaluation of the device's
ambiguous pixels, from their taps alone). The counters
``warp.source_bytes`` (the window as decoded: rows x columns x item
size), ``warp.ambiguous_px`` (the pixels re-decided) and
``warp.redecide_taps.<algorithm>`` (the taps those pixels read: 1, 4 or
16 a pixel) are always on. No stage name starts with ``read_`` or
``write_``: the campaign's ``read_*`` stages around the warps are
summed by that prefix.
"""

import logging
from datetime import datetime

import numpy as np
import torch

from proteus_tpu_torch.core.eft import f32, two_prod, two_sum
from proteus_tpu_torch.device import to_device, to_host
from proteus_tpu_torch.geo.crs import CRS, transform_points
from proteus_tpu_torch.io.tiff import TiffReader
from proteus_tpu_torch.ops import warp_kernel
from proteus_tpu_torch.runtime.profiling import COUNTERS, STAGE_TIMES

logger = logging.getLogger('dswx_hls')

# supported resampling kernels and their tap radii (the reference only
# uses 'nearest' and 'cubic'; 'cubicspline' maps to cubic convolution;
# 'average' is footprint-based — its radius is data-dependent and
# resolved per call)
_KERNEL_RADIUS = {'nearest': 0, 'bilinear': 1, 'cubic': 2,
                  'cubicspline': 2, 'average': 2}


def _cubic_weights(t):
    """GDAL cubic-convolution weights (a = -0.5) for tap offsets
    -1, 0, 1, 2 given the fractional position t in [0, 1)."""
    a = -0.5
    def w(x):
        ax = np.abs(x)
        ax2 = ax ** 2
        ax3 = ax ** 3  # once for both branches: pow is the costly step
        return np.where(
            ax <= 1, (a + 2) * ax3 - (a + 3) * ax2 + 1,
            np.where(ax < 2,
                     a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a,
                     0.0))
    return [w(t + 1), w(t), w(1 - t), w(2 - t)]


class SourceRaster:
    """A windowed view of the source raster with wrap/nodata handling."""

    def __init__(self, path):
        self.reader = TiffReader(path)
        self.gt = self.reader.geotransform()
        self.crs = self.reader.crs() or CRS.from_epsg(4326)
        self.width = self.reader.width
        self.length = self.reader.length
        self.nodata = self.reader.nodata()
        x0, dx, _, y0, _, dy = self.gt
        # global geographic sources wrap in longitude
        self.wraps = (self.crs.is_geographic
                      and abs(abs(self.width * dx) - 360.0) < 1e-6)

    def close(self):
        self.reader.close()

    def pixel_coords(self, x, y):
        """Continuous pixel-space coords (GDAL convention: 0..w, 0..h)."""
        x0, dx, _, y0, _, dy = self.gt
        u = (x - x0) / dx
        v = (y - y0) / dy
        if self.wraps:
            u = u % self.width
        return u, v


class GridTransformer:
    """Grid-interpolated coordinate transformer.

    Evaluates the exact float64 transform on a coarse lattice (every
    ``spacing`` target pixels) and bilinearly interpolates between lattice
    nodes — the same accelerization GDAL's approximate transformer uses.
    The Transverse Mercator mapping is analytic and smooth: with the
    default 8 px (240 m) spacing the interpolation error is bounded by
    (240 m)^2 / (2 R_earth) ~ 5 mm, four orders of magnitude below the
    10 m source grids. Longitudes are unwrapped across the antimeridian so
    interpolation stays continuous.
    """

    def __init__(self, tile_crs, src_crs, tx0, ty0, dx, dy, out_h, out_w,
                 spacing=8):
        self.spacing = spacing
        gi = np.arange(0, out_h + 2 * spacing, spacing, dtype=np.float64)
        gj = np.arange(0, out_w + 2 * spacing, spacing, dtype=np.float64)
        jj, ii = np.meshgrid(gj, gi)
        px = tx0 + (jj + 0.5) * dx
        py = ty0 + (ii + 0.5) * dy
        sx, sy = transform_points(tile_crs, src_crs, px.ravel(),
                                  py.ravel())
        sx = sx.reshape(jj.shape)
        sy = sy.reshape(jj.shape)
        if CRS.from_any(src_crs).is_geographic:
            # unwrap longitude jumps > 180 deg along both axes
            sx = np.unwrap(sx, period=360.0, axis=1)
            sx = np.unwrap(sx, period=360.0, axis=0)
        self.sx = sx
        self.sy = sy

    def __call__(self, i, j):
        """Transform target pixel indices (float arrays) to source CRS
        coordinates via bilinear lattice interpolation."""
        fi = i / self.spacing
        fj = j / self.spacing
        i0 = np.floor(fi).astype(np.int64)
        j0 = np.floor(fj).astype(np.int64)
        i0 = np.clip(i0, 0, self.sx.shape[0] - 2)
        j0 = np.clip(j0, 0, self.sx.shape[1] - 2)
        wi = fi - i0
        wj = fj - j0
        out = []
        for grid in (self.sx, self.sy):
            g00 = grid[i0, j0]
            g01 = grid[i0, j0 + 1]
            g10 = grid[i0 + 1, j0]
            g11 = grid[i0 + 1, j0 + 1]
            top = g00 + (g01 - g00) * wj
            bot = g10 + (g11 - g10) * wj
            out.append(top + (bot - top) * wi)
        return out[0], out[1]


def _resolve_window(src, u, v, radius):
    """Window of source pixels needed for the given pixel coords."""
    pad = radius + 2
    if src.wraps:
        return 0, 0, src.length, src.width  # modulo access: read it all
    c0 = int(np.floor(np.nanmin(u))) - pad
    c1 = int(np.ceil(np.nanmax(u))) + pad
    r0 = int(np.floor(np.nanmin(v))) - pad
    r1 = int(np.ceil(np.nanmax(v))) + pad
    c0 = max(c0, 0)
    r0 = max(r0, 0)
    c1 = min(c1, src.width)
    r1 = min(r1, src.length)
    return r0, c0, max(r1 - r0, 0), max(c1 - c0, 0)


def _read_source(src, window):
    """The pixels of ``window`` (row0, col0, height, width) of ``src``,
    its first band, C-contiguous, counted as ``warp.source_bytes``."""
    data = src.reader.read(window=window)
    if data.ndim == 3:
        data = np.ascontiguousarray(data[:, :, 0])
    COUNTERS.add('warp.source_bytes',
                 data.shape[0] * data.shape[1] * data.itemsize)
    return data


def _gather(data, valid, rows, cols, wraps, width):
    h, w = data.shape
    if wraps:
        cols = cols % width
    inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    r = np.clip(rows, 0, h - 1)
    c = np.clip(cols, 0, w - 1)
    vals = data[r, c]
    ok = inb if valid is None else (inb & valid[r, c])
    return vals, ok


def _auto_grid_spacing(tile_crs, dx):
    """Lattice spacing in target pixels for ~240 m physical spacing
    (interpolation error ~(240 m)^2 / 2R ~ 5 mm); minimum 8 px.

    Power of two so lattice weights w = i/spacing - floor(i/spacing) are
    exact in BOTH float64 (host) and float32 (device) — a precondition
    for the bit-equal device nearest path (see _device_resample_impl).
    """
    if tile_crs.is_geographic:
        return 8
    target = max(8.0, 240.0 / max(abs(dx), 1e-9))
    return int(2 ** round(np.log2(target)))


def warp_to_grid(input_file, geotransform, projection, length, width,
                 resample_algorithm='nearest', margin_in_pixels=0,
                 chunk_rows=1024, dtype=None, transformer='grid',
                 grid_spacing=None):
    """Reproject ``input_file`` onto the target grid (plus margin).

    Returns an array of shape (length + 2*margin, width + 2*margin) in the
    source dtype (or ``dtype``). Pixels with no valid source data get the
    source nodata value (or 0 if the source has none), matching the
    gdal.Warp initialization the reference relies on.
    """
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
        radius = _KERNEL_RADIUS.get(resample_algorithm)
        if radius is None:
            raise ValueError(
                f'unsupported resample algorithm: {resample_algorithm}')

        with STAGE_TIMES.stage('warp.read'):
            # coarse boundary sweep to find the needed source window
            bj = np.linspace(0, out_w, 256)
            bi = np.linspace(0, out_h, 256)
            edge_j = np.concatenate([bj, bj, np.zeros_like(bi),
                                     np.full_like(bi, out_w)])
            edge_i = np.concatenate([np.zeros_like(bj),
                                     np.full_like(bj, out_h), bi, bi])
            ex = tx0 + edge_j * dx
            ey = ty0 + edge_i * dy
            sx, sy = transform_points(tile_crs, src.crs, ex, ey)
            eu, ev = src.pixel_coords(sx, sy)
            r0, c0, wh, ww = _resolve_window(src, eu, ev, radius)
            if wh == 0 or ww == 0:
                fill = src.nodata if src.nodata is not None else 0
                out = np.full((out_h, out_w), fill)
                return out.astype(dtype or src.reader.dtype)

            data = _read_source(src, (r0, c0, wh, ww))
        out_dtype = dtype or data.dtype
        nodata = src.nodata
        with STAGE_TIMES.stage('warp.source'):
            if nodata is not None and np.isnan(nodata):
                valid = ~np.isnan(data)
            elif nodata is not None:
                valid = data != nodata
            else:
                valid = np.ones(data.shape, dtype=bool)
            all_valid = bool(valid.all())
            # 'average' reads float64 footprints; the kernels read taps
            fdata = data.astype(np.float64) \
                if resample_algorithm == 'average' else None
        fill = nodata if nodata is not None else 0

        logger.info(f'    relocating file: {input_file}'
                    f' ({resample_algorithm}, window {wh}x{ww})')

        out = np.full((out_h, out_w), fill, dtype=np.float64)

        grid_tx = None
        if transformer == 'grid':
            with STAGE_TIMES.stage('warp.lattice'):
                grid_tx = GridTransformer(tile_crs, src.crs, tx0, ty0, dx,
                                          dy, out_h, out_w,
                                          spacing=grid_spacing)

        for row0 in range(0, out_h, chunk_rows):
            rows = min(chunk_rows, out_h - row0)
            if resample_algorithm == 'average':
                # footprint-based: transform the PIXEL CORNERS
                # (index - 0.5 evaluates the center-sampled transform at
                # the corner positions)
                jj, ii = np.meshgrid(
                    np.arange(out_w + 1, dtype=np.float64) - 0.5,
                    np.arange(row0, row0 + rows + 1,
                              dtype=np.float64) - 0.5)
            else:
                jj, ii = np.meshgrid(np.arange(out_w, dtype=np.float64),
                                     np.arange(row0, row0 + rows,
                                               dtype=np.float64))
            if grid_tx is not None:
                sx, sy = grid_tx(ii, jj)
            else:
                px = tx0 + (jj + 0.5) * dx
                py = ty0 + (ii + 0.5) * dy
                sx, sy = transform_points(tile_crs, src.crs, px, py)
            u, v = src.pixel_coords(sx, sy)
            u = u - c0
            v = v - r0
            block_wraps = src.wraps and c0 == 0 and ww == src.width
            if resample_algorithm == 'average':
                block = _resample_block_average(
                    fdata, None if all_valid else valid, u, v, fill,
                    wraps=block_wraps, width=ww)
            else:
                block = _resample_block(data, valid, u, v,
                                        resample_algorithm, fill,
                                        wraps=block_wraps, width=ww,
                                        all_valid=all_valid)
            out[row0:row0 + rows, :] = block

        if np.dtype(out_dtype).kind in 'ui':
            out = np.rint(out)
            info = np.iinfo(out_dtype)
            out = np.clip(out, info.min, info.max)
        return out.astype(out_dtype)
    finally:
        src.close()


def _resample_block_average(fdata, valid, uc, vc, fill, wraps, width,
                            max_span=256):
    """GDAL 'average' semantics: area-weighted mean over the source-space
    bounding box of each target pixel's footprint.

    ``uc``/``vc`` are the CORNER coordinates of the target pixels in
    window-relative source pixel space, shape (rows+1, cols+1) — corner
    (i, j) is the top-left of pixel (i, j). Each source cell
    intersecting the footprint bbox contributes with weight equal to its
    overlap fraction per axis (gdal.Warp GRA_Average,
    gdalwarpkernel.cpp GWKAverageOrMode); nodata cells are skipped and
    the sum renormalized; zero total weight -> fill.
    """
    h, w = fdata.shape
    x00, x01 = uc[:-1, :-1], uc[:-1, 1:]
    x10, x11 = uc[1:, :-1], uc[1:, 1:]
    y00, y01 = vc[:-1, :-1], vc[:-1, 1:]
    y10, y11 = vc[1:, :-1], vc[1:, 1:]
    if wraps:
        # make the quad continuous around its top-left corner so
        # seam-crossing footprints get a sane bbox (gathers wrap below)
        def unwrap(x):
            return x - width * np.round((x - x00) / width)
        x01, x10, x11 = unwrap(x01), unwrap(x10), unwrap(x11)
    xmin = np.minimum(np.minimum(x00, x01), np.minimum(x10, x11))
    xmax = np.maximum(np.maximum(x00, x01), np.maximum(x10, x11))
    ymin = np.minimum(np.minimum(y00, y01), np.minimum(y10, y11))
    ymax = np.maximum(np.maximum(y00, y01), np.maximum(y10, y11))

    bad = ~(np.isfinite(xmin) & np.isfinite(xmax)
            & np.isfinite(ymin) & np.isfinite(ymax))
    xmin = np.where(bad, 0.0, xmin)
    xmax = np.where(bad, 0.0, xmax)
    ymin = np.where(bad, 0.0, ymin)
    ymax = np.where(bad, 0.0, ymax)

    ix0 = np.floor(xmin).astype(np.int64)
    iy0 = np.floor(ymin).astype(np.int64)
    nx = int(np.max(np.ceil(xmax) - ix0)) if xmin.size else 0
    ny = int(np.max(np.ceil(ymax) - iy0)) if ymin.size else 0
    if nx > max_span or ny > max_span:
        raise ValueError(
            f'average footprint spans {nx}x{ny} source cells; '
            f'downscale factor too extreme (cap {max_span})')

    acc = np.zeros(xmin.shape, np.float64)
    wacc = np.zeros(xmin.shape, np.float64)
    for dy in range(max(ny, 1)):
        cy = iy0 + dy
        wy = np.clip(np.minimum(cy + 1.0, ymax)
                     - np.maximum(cy, ymin), 0.0, None)
        rows_in = (cy >= 0) & (cy < h)
        cyc = np.clip(cy, 0, h - 1)
        for dx in range(max(nx, 1)):
            cx = ix0 + dx
            wx = np.clip(np.minimum(cx + 1.0, xmax)
                         - np.maximum(cx, xmin), 0.0, None)
            if wraps:
                cxc = cx % width
                cols_in = np.ones(cx.shape, bool)
            else:
                cols_in = (cx >= 0) & (cx < w)
                cxc = np.clip(cx, 0, w - 1)
            wgt = wx * wy
            vals = fdata[cyc, cxc]
            ok = rows_in & cols_in & (wgt > 0)
            if valid is not None:
                ok = ok & valid[cyc, cxc]
            acc += np.where(ok, vals * wgt, 0.0)
            wacc += np.where(ok, wgt, 0.0)
    with np.errstate(invalid='ignore', divide='ignore'):
        res = acc / wacc
    return np.where((wacc > 0) & ~bad, res, fill)


def _resample_block(data, valid, u, v, algorithm, fill, wraps, width,
                    all_valid=False):
    """Resample the window ``data`` at the window-relative source pixel
    coordinates ``u``, ``v``, in float64.

    ``data`` keeps its own dtype: each pixel's taps are gathered from it
    and from ``valid``, and only the gathered values are promoted to
    float64 (exact from integers and float32), so the cost follows the
    pixels asked for, not the window. Kernel taps are read through the
    flattened window, a view where ``data`` and ``valid`` are
    C-contiguous, as ``_read_source`` and the validity masks make them.
    Past the window's edges rows are edge-clamped and columns
    edge-clamped, or wrapped modulo the width for a wrapping source; a
    tap in a row past the window, or in a column past a non-wrapping
    window, is invalid.
    """
    h, w = data.shape
    if algorithm == 'nearest':
        rows = np.floor(v).astype(np.int64)
        cols = np.floor(u).astype(np.int64)
        vals, ok = _gather(data, None if all_valid else valid,
                           rows, cols, wraps, width)
        return np.where(ok, vals.astype(np.float64), fill)

    # kernel-based: fractional position relative to pixel centers
    uc = u - 0.5
    vc = v - 0.5
    iu = np.floor(uc).astype(np.int64)
    iv = np.floor(vc).astype(np.int64)
    fu = uc - iu
    fv = vc - iv

    if algorithm == 'bilinear':
        taps = [(0, 1 - fv), (1, fv)]
        cols_w = [(0, 1 - fu), (1, fu)]
    else:  # cubic / cubicspline
        wv = _cubic_weights(fv)
        wu = _cubic_weights(fu)
        taps = list(zip((-1, 0, 1, 2), wv))
        cols_w = list(zip((-1, 0, 1, 2), wu))

    # coordinates far outside the window (possible when the tile extends
    # past the source) clamp to PAD taps past its edge; such pixels are
    # outside center_in and masked to fill regardless
    PAD = 2
    center_in = (u >= 0) & (u <= w) & (v >= 0) & (v <= h)
    if wraps:
        iu = iu % width
        center_in = (v >= 0) & (v <= h)
    iv = np.clip(iv, -PAD, h + PAD - 1)
    iu = np.clip(iu, -PAD, w + PAD - 1)

    def _axis(base, d, n, wrap):
        # the taps' indices into the window along one axis, and whether
        # each lies inside it (None where all do: a wrapping axis)
        t = base + d
        if wrap:
            return t % n, None
        return np.clip(t, 0, n - 1), (t >= 0) & (t < n)

    rows = []
    for dr, wr in taps:
        rr, rin = _axis(iv, dr, h, False)
        rows.append((wr, rr * w, rin))  # the row's offset in ``flat``
    cols = [(wc, *_axis(iu, dc, w, wraps)) for dc, wc in cols_w]
    flat = data.reshape(-1)

    if all_valid and not wraps:
        # fast path: weights sum to 1 exactly; edge clamping stands in
        # for GDAL's kernel clamping at the source border
        acc = np.zeros(u.shape, dtype=np.float64)
        for wr, ro, _ in rows:
            for wc, cc, _ in cols:
                acc += (wr * wc) * flat[ro + cc].astype(np.float64)
        return np.where(center_in, acc, fill)

    # a wrapping source's seam-crossing tap whose wrapped column holds
    # valid data IS valid (matching the device gather); taps past the
    # rows, and past the columns of a non-wrapping source, are dropped
    # and renormalized
    vflat = None if all_valid else valid.reshape(-1)
    acc = np.zeros(u.shape, dtype=np.float64)
    wacc = np.zeros(u.shape, dtype=np.float64)
    for wr, ro, rin in rows:
        for wc, cc, cin in cols:
            idx = ro + cc
            wgt = wr * wc
            vals = flat[idx].astype(np.float64)
            if vflat is None:
                acc += vals * wgt
                wacc += wgt
            else:
                ok = rin & vflat[idx]
                if cin is not None:
                    ok &= cin
                acc += np.where(ok, vals * wgt, 0.0)
                wacc += np.where(ok, wgt, 0.0)
    with np.errstate(invalid='ignore', divide='ignore'):
        res = acc / wacc
    return np.where(center_in & (wacc > 1e-9), res, fill)


def _dd_split(x):
    """Split a float64 array into a double-float32 (hi, lo) pair.

    hi + lo carries the top ~48 bits of x; the residual is <= |x|*2^-48.
    """
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


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

    Dispatches on the tensors' device alone, after
    ``ops/warp_kernel.py::check``: CUDA tensors launch the CUDA kernel
    (``warp_kernel.resample``) or raise, CPU tensors run
    ``device_resample_plain``. There is no fallback from the kernel to the
    plain twin.
    """
    warp_kernel.check(data, valid, lat, spacing, algorithm)
    if data.device.type == 'cpu':
        return device_resample_plain(data, valid, lat, spacing, out_h, out_w,
                                     algorithm, fill, wraps, full_width)
    return warp_kernel.resample(data, valid, lat, spacing, out_h, out_w,
                                algorithm, fill, wraps, full_width)


def device_resample_plain(data, valid, lat, spacing, out_h, out_w,
                          algorithm, fill, wraps=False, full_width=None):
    """``device_resample`` in plain PyTorch (any device): the twin of the
    CUDA kernel, op for op. Every intermediate is a full-size tensor.

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
    ``warp_to_grid`` for every resampler.
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
        return to_device(out, device, 'warp_result')

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
        nodata = src.nodata
        fill = nodata if nodata is not None else 0
        out_dtype = np.dtype(dtype or src.reader.dtype)
        with STAGE_TIMES.stage('warp.read'):
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
            if wh == 0 or ww == 0:
                return torch.full((out_h, out_w), fill,
                                  dtype=torch_dtype(out_dtype),
                                  device=device)
            data = _read_source(src, (r0, c0, wh, ww))

        # float64 lattice of window-relative source pixel coordinates,
        # continuous across the antimeridian (the gather wraps per pixel)
        with STAGE_TIMES.stage('warp.lattice'):
            tx = GridTransformer(tile_crs, src.crs, tx0, ty0, dx, dy, out_h,
                                 out_w, spacing=grid_spacing)
            sx0, sdx, _, sy0, _, sdy = src.gt
            u_hi, u_lo = _dd_split((tx.sx - sx0) / sdx - c0)
            v_hi, v_lo = _dd_split((tx.sy - sy0) / sdy - r0)
            lat = tuple(to_device(a, device, 'warp_lattice')
                        for a in (u_hi, u_lo, v_hi, v_lo))
        wraps = src.wraps and c0 == 0 and ww == src.width

        with STAGE_TIMES.stage('warp.source'):
            if nodata is not None and np.isnan(nodata):
                valid = ~np.isnan(data)
            elif nodata is not None:
                valid = data != nodata
            else:
                valid = None
            kernel_input = data if resample_algorithm == 'nearest' else \
                data.astype(np.float32)
            all_valid = valid is None or bool(valid.all())
            source = to_device(kernel_input, device, 'warp_source')
            source_valid = None if all_valid else \
                to_device(valid, device, 'warp_source')

        is_float_fill = isinstance(fill, float) and np.isnan(fill)
        out, amb = device_resample(
            source, source_valid, lat, grid_spacing, out_h, out_w,
            resample_algorithm,
            float(fill) if (is_float_fill or
                            resample_algorithm != 'nearest') else fill,
            wraps=wraps, full_width=ww)
        # the window's device copy is not needed past the kernel: free it
        # before the host re-decision, as the readers warp side by side
        del source, source_valid
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
            COUNTERS.add('warp.ambiguous_px', flat.numel())
            COUNTERS.add(f'warp.redecide_taps.{resample_algorithm}',
                         flat.numel() * max(1, (2 * radius) ** 2))
            # float64 host re-evaluation of the ambiguous pixels,
            # replicating warp_to_grid's chunk pipeline (warp.py:911-942)
            # on their taps alone
            with STAGE_TIMES.stage('warp.redecide'):
                flat_np = to_host(flat, 'warp_ambiguous')
                ii = (flat_np // out_w).astype(np.float64)
                jj = (flat_np % out_w).astype(np.float64)
                hsx, hsy = tx(ii, jj)
                hu, hv = src.pixel_coords(hsx, hsy)
                res = _resample_block(
                    data, valid, hu - c0, hv - r0, resample_algorithm, fill,
                    wraps=wraps, width=ww, all_valid=all_valid)
                if to_int:
                    res = np.clip(np.rint(res), np.iinfo(out_dtype).min,
                                  np.iinfo(out_dtype).max)
                out = out.reshape(-1)
                out[flat] = to_device(res, device, 'warp_ambiguous') \
                    .to(out.dtype)
                out = out.reshape(out_h, out_w)
        return out.to(torch_dtype(out_dtype))
    finally:
        src.close()


def worldcover_year_of(worldcover_file, worldcover_file_description=None):
    """Extract the WorldCover dataset year (reference
    dswx_hls.py:1055-1095): from time_start/time_end metadata, else from a
    year in the description, else 2000."""
    with TiffReader(worldcover_file) as r:
        md = r.metadata()
    if 'time_start' in md and 'time_end' in md:
        fmt = '%Y-%m-%dT%H:%M:%SZ'
        t0 = datetime.strptime(md['time_start'], fmt)
        t1 = datetime.strptime(md['time_end'], fmt)
        year = (t0 + (t1 - t0) / 2.0).year
        logger.info(f'    ESA WorldCover map year: {year}'
                    ' (source: WorldCover file metadata)')
        return year
    if worldcover_file_description:
        logger.warning('WARNING Could not read the ESA WorldCover 10m'
                       ' metadata fields `time_start` and/or `time_end`')
        for year in range(2000, 2100):
            if str(year) in worldcover_file_description:
                logger.info(f'    ESA WorldCover map year: {year}'
                            ' (source: WorldCover file description)')
                return year
        logger.warning('WARNING Could not infer the ESA WorldCover 10m'
                       ' data year from the WorldCover file description.'
                       ' Considering year as 2000.')
        return 2000
    logger.warning('WARNING Could not read the ESA WorldCover 10m metadata'
                   ' fields `time_start` and/or `time_end`.'
                   ' Considering year as 2000.')
    return 2000
