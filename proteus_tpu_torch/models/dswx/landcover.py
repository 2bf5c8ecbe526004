"""LAND layer: combine CGLS Land Cover 100 m with ESA WorldCover 10 m.

Port of ``proteus_tpu/models/dswx/landcover.py:17-73``: the inputs are
already warped to the product grid (CGLS at 1x, WorldCover at 3x
supersampling); the water/urban/tree masks are 3x3 sum-decimated and
combined through the threshold hierarchy.
"""

import torch

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.ops.resample import decimate_by_summation


def create_landcover_mask_arrays(copernicus_landcover_array,
                                 worldcover_array_up_3,
                                 mask_type: str,
                                 forest_mask_landcover_classes,
                                 worldcover_year: int = 2000):
    """Build the LAND hierarchy (uint8) from pre-warped landcover tensors:
    (H, W) CGLS classes and (3H, 3W) WorldCover classes."""
    wc = worldcover_array_up_3
    water = ((wc == C.WORLDCOVER_WATER_CLASSES[0]) |
             (wc == C.WORLDCOVER_WATER_CLASSES[1]) |
             (wc == C.WORLDCOVER_WATER_CLASSES[2]))
    water_sum = decimate_by_summation(water.to(torch.uint8), 3, 3)
    urban_sum = decimate_by_summation(
        (wc == C.WORLDCOVER_URBAN_CLASS).to(torch.uint8), 3, 3)
    tree_sum = decimate_by_summation(
        (wc == C.WORLDCOVER_TREE_CLASS).to(torch.uint8), 3, 3)

    cgls = copernicus_landcover_array
    forest = torch.zeros(cgls.shape, dtype=torch.bool, device=cgls.device)
    for cls in (forest_mask_landcover_classes or ()):
        forest = forest | (cgls == int(cls))
    tree_sum = torch.where(forest, tree_sum, 0)

    thresholds = C.LANDCOVER_THRESHOLD_DICT[mask_type.lower()]
    classes = C.DSWX_HLS_LANDCOVER_CLASSES_DICT
    year_offset = int(worldcover_year) - 2000
    out = torch.full(water_sum.shape, classes['fill_value'],
                     dtype=torch.uint8, device=cgls.device)
    # hierarchy (later assignments take precedence, as in the reference):
    # evergreen, low-intensity developed, high-intensity developed, water
    for total, threshold, value in (
            (tree_sum, thresholds[0], classes['evergreen_forest']),
            (urban_sum, thresholds[1],
             classes['low_intensity_developed_offset'] + year_offset),
            (urban_sum, thresholds[2],
             classes['high_intensity_developed_offset'] + year_offset),
            (water_sum, thresholds[3], classes['water'])):
        out = torch.where(total >= threshold, value, out)
    return out
