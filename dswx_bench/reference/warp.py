"""The plain warp of an EPSG:4326 raster onto a UTM product grid.

A frozen copy of the float64 host warp that the program's device warp is
held to bit for bit (``proteus_tpu_torch/geo/warp.py``: ``GridTransformer``,
``_resolve_window``, ``_gather``, ``_auto_grid_spacing``, ``warp_to_grid``
and ``_resample_block`` for 'nearest' and 'cubic'), with the UTM inverse
of ``geo/crs_tm.py`` (the Krueger-Karney 6th-order series) in place of
the program's CRS engine. It reads the source as an array with its
geotransform instead of a file. The interpolation runs in ``work``:
float64 as the science states, float32 for the control.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np

_A, _INVF = 6378137.0, 298.257223563     # WGS84
_K0, _FALSE_EASTING = 0.9996, 500000.0


def _tm_series():
    f = 1.0 / _INVF
    e2 = f * (2.0 - f)
    e = np.sqrt(e2)
    n = f / (2.0 - f)
    a_hat = _A / (1 + n) * (1 + n ** 2 / 4 + n ** 4 / 64 + n ** 6 / 256)
    beta = np.array([
        n / 2 - 2 * n ** 2 / 3 + 37 * n ** 3 / 96 - n ** 4 / 360
        - 81 * n ** 5 / 512 + 96199 * n ** 6 / 604800,
        n ** 2 / 48 + n ** 3 / 15 - 437 * n ** 4 / 1440
        + 46 * n ** 5 / 105 - 1118711 * n ** 6 / 3870720,
        17 * n ** 3 / 480 - 37 * n ** 4 / 840 - 209 * n ** 5 / 4480
        + 5569 * n ** 6 / 90720,
        4397 * n ** 4 / 161280 - 11 * n ** 5 / 504
        - 830251 * n ** 6 / 7257600,
        4583 * n ** 5 / 161280 - 108847 * n ** 6 / 3991680,
        20648693 * n ** 6 / 638668800,
    ])
    return e, e2, a_hat, beta


def utm_inverse(x, y, zone, north=True):
    """UTM easting/northing (WGS84) -> (lat, lon) degrees, float64."""
    e, e2, a_hat, beta = _tm_series()
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if not north:
        y = y - 10000000.0
    xi = y / (_K0 * a_hat)
    eta = (x - _FALSE_EASTING) / (_K0 * a_hat)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi_p = xi_p - beta[j] * np.sin(k * xi) * np.cosh(k * eta)
        eta_p = eta_p - beta[j] * np.cos(k * xi) * np.sinh(k * eta)
    sinh_eta = np.sinh(eta_p)
    cos_xi = np.cos(xi_p)
    dlon = np.arctan2(sinh_eta, cos_xi)
    tau_p = np.sin(xi_p) / np.sqrt(sinh_eta ** 2 + cos_xi ** 2)
    tau = tau_p / (1.0 - e2)
    for _ in range(5):
        sigma = np.sinh(e * np.arctanh(e * tau / np.sqrt(1.0 + tau ** 2)))
        tau_p_i = tau * np.sqrt(1.0 + sigma ** 2) \
            - sigma * np.sqrt(1.0 + tau ** 2)
        dtau = ((tau_p - tau_p_i) * (1.0 + (1.0 - e2) * tau ** 2)
                / ((1.0 - e2)
                   * np.sqrt((1.0 + tau_p_i ** 2) * (1.0 + tau ** 2))))
        tau = tau + dtau
    lat = np.degrees(np.arctan(tau))
    lon0 = zone * 6.0 - 183.0
    lon = lon0 + np.degrees(dlon)
    lon = (lon + 180.0) % 360.0 - 180.0
    return lat, lon


def _to_lonlat(zone, x, y):
    lat, lon = utm_inverse(x, y, zone)
    return lon, lat


def _cubic_weights(t):
    a = -0.5

    def w(x):
        ax = np.abs(x)
        return np.where(
            ax <= 1, (a + 2) * ax ** 3 - (a + 3) * ax ** 2 + 1,
            np.where(ax < 2,
                     a * ax ** 3 - 5 * a * ax ** 2 + 8 * a * ax - 4 * a,
                     0.0))
    return [w(t + 1), w(t), w(1 - t), w(2 - t)]


class GridTransformer:
    """The exact transform on a lattice every ``spacing`` target pixels,
    bilinear in between."""

    def __init__(self, zone, tx0, ty0, dx, dy, out_h, out_w, spacing):
        self.spacing = spacing
        gi = np.arange(0, out_h + 2 * spacing, spacing, dtype=np.float64)
        gj = np.arange(0, out_w + 2 * spacing, spacing, dtype=np.float64)
        jj, ii = np.meshgrid(gj, gi)
        px = tx0 + (jj + 0.5) * dx
        py = ty0 + (ii + 0.5) * dy
        sx, sy = _to_lonlat(zone, px.ravel(), py.ravel())
        sx = np.unwrap(sx.reshape(jj.shape), period=360.0, axis=1)
        self.sx = np.unwrap(sx, period=360.0, axis=0)
        self.sy = sy.reshape(jj.shape)

    def __call__(self, i, j):
        fi = i / self.spacing
        fj = j / self.spacing
        i0 = np.clip(np.floor(fi).astype(np.int64), 0, self.sx.shape[0] - 2)
        j0 = np.clip(np.floor(fj).astype(np.int64), 0, self.sx.shape[1] - 2)
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


def grid_spacing(dx):
    """The lattice spacing in target pixels for about 240 m, a power of
    two, at least 8."""
    target = max(8.0, 240.0 / max(abs(dx), 1e-9))
    return int(2 ** round(np.log2(target)))


def source_window(zone, src_gt, src_shape, tx0, ty0, dx, dy, out_h, out_w,
                  radius):
    """(r0, c0, rows, cols) of the source read for a target grid: the
    coarse boundary sweep of the program's warp."""
    bj = np.linspace(0, out_w, 256)
    bi = np.linspace(0, out_h, 256)
    ej = np.concatenate([bj, bj, np.zeros_like(bi), np.full_like(bi, out_w)])
    ei = np.concatenate([np.zeros_like(bj), np.full_like(bj, out_h), bi, bi])
    sx, sy = _to_lonlat(zone, tx0 + ej * dx, ty0 + ei * dy)
    sx0, sdx, _, sy0, _, sdy = src_gt
    u = (sx - sx0) / sdx
    v = (sy - sy0) / sdy
    pad = radius + 2
    c0 = max(int(np.floor(np.nanmin(u))) - pad, 0)
    c1 = min(int(np.ceil(np.nanmax(u))) + pad, src_shape[1])
    r0 = max(int(np.floor(np.nanmin(v))) - pad, 0)
    r1 = min(int(np.ceil(np.nanmax(v))) + pad, src_shape[0])
    return r0, c0, max(r1 - r0, 0), max(c1 - c0, 0)


def _nearest(data, u, v):
    rows = np.floor(v).astype(np.int64)
    cols = np.floor(u).astype(np.int64)
    h, w = data.shape
    inb = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    flat = np.clip(rows, 0, h - 1) * w + np.clip(cols, 0, w - 1)
    return np.take(data.reshape(-1), flat), inb


def _cubic(dpad, h, w, u, v, work):
    """The fast path of an all-valid source: 16 taps on the edge-padded
    source, weights summing to 1."""
    pad = 2
    uc = (u - 0.5).astype(work)
    vc = (v - 0.5).astype(work)
    iu = np.floor(uc).astype(np.int64)
    iv = np.floor(vc).astype(np.int64)
    fu = uc - iu.astype(work)
    fv = vc - iv.astype(work)
    wv = _cubic_weights(fv)
    wu = _cubic_weights(fu)
    center_in = (u >= 0) & (u <= w) & (v >= 0) & (v <= h)
    rbase = np.clip(iv, -pad, h + pad - 1) + pad
    cbase = np.clip(iu, -pad, w + pad - 1) + pad
    # the taps' flat indices into the padded source, row part and column
    # part apart: the same elements as dpad[rr, cc]
    pw = w + 2 * pad
    rows = [np.clip(rbase + dr, 0, h + 2 * pad - 1) * pw
            for dr in (-1, 0, 1, 2)]
    cols = [np.clip(cbase + dc, 0, pw - 1) for dc in (-1, 0, 1, 2)]
    flat = dpad.reshape(-1)
    acc = np.zeros(u.shape, dtype=work)
    for rr, wr in zip(rows, wv):
        for cc, wc in zip(cols, wu):
            acc += (wr * wc).astype(work) * np.take(flat, rr + cc)
    return acc, center_in


def warp(src, src_gt, zone, geotransform, length, width, algorithm,
         nodata, margin=0, work=np.float64, chunk_rows=256, threads=8):
    """``src`` (an EPSG:4326 array with geotransform ``src_gt``) on the
    product grid ``geotransform`` of UTM ``zone`` north, plus ``margin``
    pixels a side, in the source's dtype; pixels with no source get
    ``nodata``. An all-valid source is assumed (the benchmark's inputs
    have no nodata pixel), as the program's fast path does."""
    m = margin
    x0, dx, _, y0, _, dy = geotransform
    tx0, ty0 = x0 - m * dx, y0 - m * dy
    out_h, out_w = length + 2 * m, width + 2 * m
    radius = {'nearest': 0, 'cubic': 2}[algorithm]
    r0, c0, wh, ww = source_window(zone, src_gt, src.shape, tx0, ty0, dx,
                                   dy, out_h, out_w, radius)
    data = src[r0:r0 + wh, c0:c0 + ww]
    if algorithm == 'cubic':
        if np.isnan(data).any():
            raise ValueError('the plain warp takes an all-valid source')
        fdata = data.astype(work)
        dpad = np.pad(np.pad(fdata, ((2, 2), (0, 0)), mode='edge'),
                      ((0, 0), (2, 2)), mode='edge')
    grid = GridTransformer(zone, tx0, ty0, dx, dy, out_h, out_w,
                           grid_spacing(dx))
    sx0, sdx, _, sy0, _, sdy = src_gt
    out = np.empty((out_h, out_w), src.dtype)

    def block(row0):
        rows = min(chunk_rows, out_h - row0)
        # a column of row numbers against a row of column numbers: the
        # lattice arithmetic of each pixel as on the full meshgrid
        ii = np.arange(row0, row0 + rows, dtype=np.float64)[:, None]
        jj = np.arange(out_w, dtype=np.float64)[None, :]
        sx, sy = grid(ii, jj)
        u = (sx - sx0) / sdx - c0
        v = (sy - sy0) / sdy - r0
        if algorithm == 'nearest':
            vals, ok = _nearest(data, u, v)
            res = np.where(ok, vals, nodata)
        else:
            acc, ok = _cubic(dpad, wh, ww, u, v, work)
            res = np.where(ok, acc, nodata)
        out[row0:row0 + rows] = res.astype(src.dtype)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(block, range(0, out_h, chunk_rows)))
    return out
