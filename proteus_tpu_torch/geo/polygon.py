"""The ocean mask: shoreline polygons rasterized on the host, buffered
seaward on the device.

Port of ``proteus_tpu/geo/polygon.py::create_ocean_mask`` (:161-243) in its
``as_device`` form. The rasterization below is copied from :173-227 (that
function's buffer branch imports ``jax``). It clips each polygon to the
tile box expanded by twice the margin before it projects the vertices, and
the edges between projected vertices are straight, so the rasterized coast
depends on that box: the land raster itself must be the reference's, and
not the one of a zero margin. The buffer is the ellipse dilation
``proteus_tpu_torch.ops.morphology.dilate_ellipse``.
"""

import logging

import numpy as np
import torch

from proteus_tpu_torch.host import (CRS, clip_ring_to_rect, rasterize_rings,
                                    read_shapefile, transform_points)
from proteus_tpu_torch.ops.morphology import dilate_ellipse

logger = logging.getLogger('dswx_hls')


def rasterize_land(shapefile, margin_m, geotransform, projection, length,
                   width):
    """Land (1) / ocean (0) raster of the shoreline polygons on the tile
    grid, uint8 numpy, clipped as the reference clips for ``margin_m``."""
    x0, dx, _, y0, _, dy = geotransform
    xmax = x0 + width * dx
    ymin = y0 + length * dy
    tile_crs = CRS.from_any(projection)

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
    return land


def create_ocean_mask(shapefile, margin_km, geotransform, projection,
                      length, width, device):
    """Ocean mask from the GSHHS shoreline (1: land, 0: ocean), uint8 on
    ``device``: land rasterized on the host, then dilated seaward by
    ``margin_km`` on the device."""
    logger.info('creating the ocean mask')
    margin_m = int(1000 * margin_km)
    land = rasterize_land(shapefile, margin_m, geotransform, projection,
                          length, width)
    _, dx, _, _, _, dy = geotransform
    return dilate_ellipse(torch.from_numpy(land).to(device), margin_m, dy,
                          dx)
