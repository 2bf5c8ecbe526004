"""Browse-image array generation.

Port of ``proteus_tpu/models/dswx/browse.py`` (reference
_compute_browse_array, dswx_hls.py:3057-3129).
"""

import torch

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.models.dswx.interpretation import collapse_wtr_classes


def compute_browse_array(masked_interpreted_water_layer,
                         flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
                         exclude_psw_aggressive=False,
                         set_not_water_to_nodata=False,
                         set_cloud_to_nodata=False,
                         set_snow_to_nodata=False,
                         set_ocean_masked_to_nodata=True):
    fill = C.UINT8_FILL_VALUE
    arr = masked_interpreted_water_layer
    if exclude_psw_aggressive:
        arr = torch.where(
            arr == C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR,
            C.WATER_NOT_WATER_CLEAR, arr)
    if flag_collapse_wtr_classes:
        arr = collapse_wtr_classes(arr)
    for flag, value in ((set_not_water_to_nodata, C.WATER_NOT_WATER_CLEAR),
                        (set_cloud_to_nodata, C.WTR_CLOUD_MASKED),
                        (set_snow_to_nodata, C.WTR_SNOW_MASKED),
                        (set_ocean_masked_to_nodata, C.WTR_OCEAN_MASKED)):
        if flag:
            arr = torch.where(arr == value, fill, arr)
    return arr
