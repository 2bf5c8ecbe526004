"""A tile's ancillary layers on its product grid: the DEM warp, the
terrain shadow and LAND.

The one definition of the science that both product paths run: the SAS
(``runtime/orchestrator.py::generate_dswx_layers``) and the campaign's
reader (``parallel/campaign.py::_read_tile``). What belongs to one path alone
stays with it: its stages and their synchronizations, the SAS's file
checks, the campaign's cache keys, its moves between devices and its prep
pool. Nothing here opens a stage or a span; the warps' ``warp.*`` stages
are ``geo/warp.py``'s own. The warp is looked up in ``geo.warp`` at call
time, so that a patch of ``geo.warp.warp_to_grid_device`` sees every
call.
"""

import torch

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.geo import warp
from proteus_tpu_torch.models.dswx.landcover import \
    create_landcover_mask_arrays
from proteus_tpu_torch.models.dswx.shadow import (
    compute_opera_shadow_layer_exact, compute_otsu_shadow_layer_exact)


def mean_sun_angle(meta_value):
    """An HLS sun-angle attribute as one angle: the mean of the two
    values of a ``'a, b'`` pair, else its one value."""
    parts = str(meta_value).split(', ')
    if len(parts) == 2:
        return (float(parts[0]) + float(parts[1])) / 2.0
    return float(parts[0])


def crop_margin(array, margin):
    """``array`` (a tensor or an ndarray) without ``margin`` pixels on
    each side: a view."""
    return array[margin:-margin, margin:-margin]


def warp_dem(dem_file, geotransform, projection, length, width, device):
    """The DEM cubic-warped onto the product grid with
    ``C.DEM_MARGIN_IN_PIXELS`` on each side, a tensor on ``device``."""
    return warp.warp_to_grid_device(
        dem_file, geotransform, projection, length, width,
        resample_algorithm='cubic', margin_in_pixels=C.DEM_MARGIN_IN_PIXELS,
        device=device)


def terrain_shadow(dem_with_margin, geotransform, sun_azimuth, sun_zenith,
                   config):
    """SHAD (1: not shadow) by ``config.shadow_masking_algorithm`` over
    ``warp_dem``'s DEM, cropped to the grid: a contiguous uint8 tensor.
    'otsu' is the hillshade's Otsu cut at the grid's pixel spacings
    (reference dswx_hls.py:4430-4436); any other value the local
    incidence angle test with ``config.min_slope_angle`` and
    ``config.max_sun_local_inc_angle``."""
    sun_elevation = 90 - sun_zenith
    if config.shadow_masking_algorithm == 'otsu':
        shadow = compute_otsu_shadow_layer_exact(
            dem_with_margin, sun_azimuth, sun_elevation,
            pixel_spacing_x=geotransform[1], pixel_spacing_y=geotransform[5])
    else:
        shadow = compute_opera_shadow_layer_exact(
            dem_with_margin, sun_azimuth, sun_elevation,
            config.min_slope_angle, config.max_sun_local_inc_angle)
    return crop_margin(shadow, C.DEM_MARGIN_IN_PIXELS) \
        .to(torch.uint8).contiguous()


def landcover_mask(landcover_file, worldcover_file, geotransform,
                   projection, length, width, forest_classes, device,
                   worldcover_description=None):
    """LAND of the grid, a contiguous uint8 tensor on ``device``: CGLS
    warped onto the grid, WorldCover onto the grid 3 times finer (which
    LAND sum-decimates), both nearest, combined with the WorldCover
    year (from the file, else ``worldcover_description``)."""
    cgls = warp.warp_to_grid_device(
        landcover_file, geotransform, projection, length, width,
        resample_algorithm='nearest', device=device)
    gt3 = (geotransform[0], geotransform[1] / 3, 0.0,
           geotransform[3], 0.0, geotransform[5] / 3)
    wc3 = warp.warp_to_grid_device(
        worldcover_file, gt3, projection, 3 * length, 3 * width,
        resample_algorithm='nearest', device=device)
    year = warp.worldcover_year_of(worldcover_file, worldcover_description)
    return create_landcover_mask_arrays(
        cgls, wc3, C.LANDCOVER_MASK_TYPE, forest_classes,
        worldcover_year=year).to(torch.uint8).contiguous()
