"""DIAG -> WTR-1 interpretation, class collapse, BWTR and CONF layers.

Port of ``proteus_tpu/models/dswx/interpretation.py``. The lookup tables
are built on the host once and indexed as tensors on the layer's device.
"""

import numpy as np
import torch

from proteus_tpu_torch.core import constants as C

_INTERP_LUT = C.build_interpretation_lut()          # 33 entries
_COLLAPSE_LUT = C.build_collapse_lut()              # 256 entries


def _lut(table, like):
    return torch.as_tensor(table, device=like.device)


def generate_interpreted_layer(diagnostic_layer_decimal):
    """Map the 5-bit DIAG decimal value to water classes (WTR-1), uint8.
    Unknown values map to UINT8_FILL_VALUE."""
    d = diagnostic_layer_decimal.to(torch.int64)
    top = len(_INTERP_LUT) - 1
    out = _lut(_INTERP_LUT, d)[d.clamp(0, top)]
    return torch.where(d > top, C.UINT8_FILL_VALUE, out)


def collapse_wtr_classes(interpreted_layer):
    """Collapse the 4 internal water classes to the 2 product classes."""
    return _lut(_COLLAPSE_LUT, interpreted_layer)[
        interpreted_layer.to(torch.int64)]


def get_binary_water_layer(wtr_layer):
    """BWTR: classes 1..4 -> 1; everything else passes through."""
    is_water = (wtr_layer >= C.FIRST_UNCOLLAPSED_WATER_CLASS) & \
               (wtr_layer <= C.LAST_UNCOLLAPSED_WATER_CLASS)
    return torch.where(is_water, C.BWTR_WATER, wtr_layer)


def _conf_luts():
    """256-entry LUTs for the CONF layer cloud/snow class rewrites."""
    cloud_lut = np.arange(256, dtype=np.uint8)
    snow_lut = np.arange(256, dtype=np.uint8)
    for c in range(5):
        cloud_lut[c] = c + 10
        snow_lut[c] = c + 20
    return cloud_lut, snow_lut


_CONF_CLOUD_LUT, _CONF_SNOW_LUT = _conf_luts()
_CONF_CLOUD_VALUES_LUT = np.zeros(256, dtype=bool)
_CONF_CLOUD_VALUES_LUT[list(C.CONF_CLOUD_VALUES)] = True


def get_confidence_layer(wtr_2_layer, cloud_layer):
    """CONF layer: uncollapsed WTR-2 with +10 (cloud) / +20 (snow) offsets.
    Cloud has precedence over snow (CLOUD == 2 exactly)."""
    cloud_idx = _lut(_CONF_CLOUD_VALUES_LUT, cloud_layer)[
        cloud_layer.to(torch.int64)]
    snow_idx = cloud_layer == C.CONF_SNOW_VALUE
    w = wtr_2_layer.to(torch.int64)
    cloud_mapped = _lut(_CONF_CLOUD_LUT, w)[w]
    snow_mapped = _lut(_CONF_SNOW_LUT, w)[w]
    conf = torch.where(cloud_idx, cloud_mapped, wtr_2_layer)
    return torch.where(snow_idx & ~cloud_idx, snow_mapped, conf)
