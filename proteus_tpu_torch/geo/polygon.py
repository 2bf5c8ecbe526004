"""Polygon clipping, rasterization, and the ocean mask.

Port of ``proteus_tpu/geo/polygon.py``; ``clip_ring_to_rect``,
``rasterize_rings`` and ``create_ocean_mask`` are copied from :24-243. Each
shoreline polygon is clipped to the tile box expanded by twice the margin
(Sutherland-Hodgman), its vertices are transformed with the port's CRS
engine, and it is rasterized even-odd at pixel centers. The clip box moves
the rasterized coast (the edges between projected vertices are straight),
so the land raster is always the reference's. The seaward buffer is the
Euclidean distance-transform threshold on the host, or, given a
``device``, the ellipse dilation ``proteus_tpu_torch.ops.morphology.
dilate_ellipse`` there (the JAX package's ``as_device`` branch).
"""

import logging

import numpy as np
import torch
from scipy.ndimage import distance_transform_edt

from proteus_tpu_torch.device import to_device
from proteus_tpu_torch.geo.crs import CRS, transform_points
from proteus_tpu_torch.io.shapefile import read_shapefile
from proteus_tpu_torch.ops.morphology import dilate_ellipse

logger = logging.getLogger('dswx_hls')


def clip_ring_to_rect(ring, xmin, ymin, xmax, ymax):
    """Sutherland-Hodgman clip of a closed ring to an axis-aligned rect."""
    def clip_edge(points, inside, intersect):
        if len(points) == 0:
            return points
        out = []
        prev = points[-1]
        prev_in = inside(prev)
        for cur in points:
            cur_in = inside(cur)
            if cur_in:
                if not prev_in:
                    out.append(intersect(prev, cur))
                out.append(cur)
            elif prev_in:
                out.append(intersect(prev, cur))
            prev, prev_in = cur, cur_in
        return out

    def x_intersect(p, q, x):
        t = (x - p[0]) / (q[0] - p[0])
        return (x, p[1] + t * (q[1] - p[1]))

    def y_intersect(p, q, y):
        t = (y - p[1]) / (q[1] - p[1])
        return (p[0] + t * (q[0] - p[0]), y)

    pts = [tuple(p) for p in np.asarray(ring)]
    pts = clip_edge(pts, lambda p: p[0] >= xmin,
                    lambda p, q: x_intersect(p, q, xmin))
    pts = clip_edge(pts, lambda p: p[0] <= xmax,
                    lambda p, q: x_intersect(p, q, xmax))
    pts = clip_edge(pts, lambda p: p[1] >= ymin,
                    lambda p, q: y_intersect(p, q, ymin))
    pts = clip_edge(pts, lambda p: p[1] <= ymax,
                    lambda p, q: y_intersect(p, q, ymax))
    if len(pts) < 3:
        return None
    return np.array(pts, dtype=np.float64)


def rasterize_rings(rings, geotransform, length, width, out=None):
    """Even-odd rasterization of polygon rings at pixel centers.

    Matches GDAL RasterizeLayer semantics (burn where the pixel center is
    inside). Fully vectorized scanline: all edge/row crossings are
    computed in one NumPy pass (rows expanded with a repeat/arange trick),
    then even-odd spans fill through a per-row difference array — no
    Python loop over edges or rows, so full-resolution GSHHS shorelines
    (100k+ vertices) rasterize in milliseconds.
    """
    x0, dx, _, y0, _, dy = geotransform
    if out is None:
        out = np.zeros((length, width), dtype=np.uint8)

    # gather all edges from all rings
    p1 = []
    p2 = []
    for ring in rings:
        pts = np.asarray(ring, dtype=np.float64)
        if len(pts) < 3:
            continue
        nxt = np.roll(pts, -1, axis=0)
        p1.append(pts)
        p2.append(nxt)
    if not p1:
        return out
    p1 = np.concatenate(p1)
    p2 = np.concatenate(p2)
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    keep = y1 != y2
    x1, y1, x2, y2 = x1[keep], y1[keep], x2[keep], y2[keep]
    if x1.size == 0:
        return out

    # pixel-center y of row i: yc(i) = y0 + (i + 0.5) * dy; an edge
    # contributes a crossing at every row whose center lies in the
    # half-open interval [min(y1,y2), max(y1,y2)).
    ylo = np.minimum(y1, y2)
    yhi = np.maximum(y1, y2)

    def f(yv):  # real-valued row index whose center equals yv
        return (yv - y0) / dy - 0.5
    if dy < 0:
        # yc decreases with i: yc >= ylo -> i <= f(ylo);
        # yc < yhi -> i > f(yhi)
        r_start = np.floor(f(yhi)).astype(np.int64) + 1
        r_end = np.floor(f(ylo)).astype(np.int64)
    else:
        # yc increases with i: yc >= ylo -> i >= f(ylo);
        # yc < yhi -> i < f(yhi)
        r_start = np.ceil(f(ylo)).astype(np.int64)
        r_end = np.ceil(f(yhi)).astype(np.int64) - 1
    r_start = np.clip(r_start, 0, length)
    r_end = np.clip(r_end, -1, length - 1)
    counts = np.maximum(r_end - r_start + 1, 0)
    total = int(counts.sum())
    if total == 0:
        return out

    # expand (edge, row) pairs: rows = r_start[e] + arange within count
    edge_idx = np.repeat(np.arange(x1.size), counts)
    offsets = np.arange(total) - np.repeat(
        np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    rows = r_start[edge_idx] + offsets
    yc = y0 + (rows + 0.5) * dy
    t = (yc - y1[edge_idx]) / (y2[edge_idx] - y1[edge_idx])
    xs = x1[edge_idx] + t * (x2[edge_idx] - x1[edge_idx])

    # per-row even-odd spans: sort by (row, x); pair consecutive
    # crossings; fill via difference array + cumulative sum
    order = np.lexsort((xs, rows))
    rows = rows[order]
    xs = xs[order]
    # crossings per row are even for closed rings; pair (0,1), (2,3)...
    pos_in_row = np.arange(rows.size) - np.searchsorted(rows, rows)
    is_open = (pos_in_row % 2) == 0
    xa = xs[is_open]
    xb = xs[~is_open]
    ra = rows[is_open]
    half_px = 0.5 * dx
    c0 = np.ceil((xa - x0 - half_px) / dx).astype(np.int64)
    c1 = np.ceil((xb - x0 - half_px) / dx).astype(np.int64)
    c0 = np.clip(c0, 0, width)
    c1 = np.clip(c1, 0, width)
    good = c1 > c0
    if not good.any():
        return out
    diff = np.zeros((length, width + 1), dtype=np.int32)
    np.add.at(diff, (ra[good], c0[good]), 1)
    np.add.at(diff, (ra[good], c1[good]), -1)
    inside = np.cumsum(diff, axis=1)[:, :width] > 0
    out |= inside.astype(np.uint8)
    return out


def create_ocean_mask(shapefile, margin_km, scratch_dir, geotransform,
                      projection, length, width, temp_files_list=None,
                      device=None):
    """Ocean mask from the GSHHS shoreline (1: land, 0: ocean).

    Shoreline polygons are land; the mask is land rasterized then dilated
    seaward by ``margin_km``. Given a ``device``, the metric buffer runs
    there as an ellipse dilation (equivalent to the host Euclidean
    distance transform threshold) and the mask is a uint8 tensor on it;
    without one it is a uint8 numpy array.
    """
    del scratch_dir, temp_files_list  # no temporary files needed
    logger.info('creating the ocean mask')
    x0, dx, _, y0, _, dy = geotransform
    xmax = x0 + width * dx
    ymin = y0 + length * dy
    tile_crs = CRS.from_any(projection)
    margin_m = int(1000 * margin_km)

    polygons, crs_wkt = read_shapefile(shapefile)
    poly_crs = CRS.from_wkt(crs_wkt) if crs_wkt else CRS.from_epsg(4326)

    # tile bbox in the shapefile CRS, expanded by 2x the margin (reference
    # dswx_hls.py:3521-3526)
    corners_x = np.array([x0, xmax, xmax, x0]) + \
        np.array([-1, 1, 1, -1]) * 2 * margin_m
    corners_y = np.array([y0, y0, ymin, ymin]) + \
        np.array([1, 1, -1, -1]) * 2 * margin_m
    cx, cy = transform_points(tile_crs, poly_crs, corners_x, corners_y)
    bxmin, bxmax = cx.min(), cx.max()
    bymin, bymax = cy.min(), cy.max()
    antimeridian = bxmax > bxmin + 340
    if antimeridian:
        # treat the tile box as [max, min+360] (reference
        # dswx_hls.py:3447-3450)
        bxmin, bxmax = bxmax, bxmin + 360

    land = np.zeros((length, width), dtype=np.uint8)
    for poly in polygons:
        pxmin, pymin, pxmax, pymax = poly.bbox
        shifted_rings = [poly.rings]
        if antimeridian:
            # test both the original and +360-shifted copies
            shifted_rings = [poly.rings,
                             [r + np.array([360.0, 0.0]) for r in
                              poly.rings]]
        for rings in shifted_rings:
            xs = np.concatenate([r[:, 0] for r in rings])
            ys = np.concatenate([r[:, 1] for r in rings])
            if (xs.max() < bxmin or xs.min() > bxmax
                    or ys.max() < bymin or ys.min() > bymax):
                continue
            clipped = []
            for ring in rings:
                c = clip_ring_to_rect(ring, bxmin, bymin, bxmax, bymax)
                if c is not None:
                    clipped.append(c)
            if not clipped:
                continue
            utm_rings = []
            for ring in clipped:
                ux, uy = transform_points(poly_crs, tile_crs,
                                          ring[:, 0], ring[:, 1])
                utm_rings.append(np.stack([ux, uy], axis=1))
            rasterize_rings(utm_rings, geotransform, length, width,
                            out=land)

    if device is not None:
        mask = to_device(land, device, 'ocean_mask')
        if margin_m > 0 and land.any():
            mask = dilate_ellipse(mask, margin_m, dy, dx)
        return mask

    if margin_m > 0 and land.any():
        # seaward buffer: distance from land <= margin (exact Euclidean
        # distance transform, anisotropy-aware via pixel sampling)
        dist = distance_transform_edt(land == 0,
                                      sampling=(abs(dy), abs(dx)))
        land = (dist <= margin_m).astype(np.uint8)
    return land
