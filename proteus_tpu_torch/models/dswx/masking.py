"""Aerosol, landcover, shadow, and cloud masking of the interpreted layer.

Port of ``proteus_tpu/models/dswx/masking.py``: every cloud-adjacent mode
('mask', 'ignore', and 'cover' with its two masked binary dilations), on
int16 or float32 reflectance. On int16 bands an ``lcmask_nir`` that is not
an exact rational is compared through its integer bound
(``core/f32exact.py``), as in the reference.
"""

import numpy as np
import torch

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.core.f32exact import int_gt_bound
from proteus_tpu_torch.core.thresholds import (SCALAR_MAX_DEN,
                                               SCALAR_MAX_NUM, HlsThresholds,
                                               to_exact_fraction)
from proteus_tpu_torch.models.dswx.diagnostics import f32
from proteus_tpu_torch.ops.morphology import binary_dilation_masked


# copied from proteus_tpu/models/dswx/masking.py:25-41 (numpy only; that
# module imports jax)
def build_aerosol_fmask_lut(
        not_water_values, moderate_conf_values,
        psw_conservative_values, psw_aggressive_values):
    """Pack the four aerosol fmask-value lists into one 256-entry bitmask LUT.

    bit k of lut[fmask] says "fmask value triggers remap of class list k",
    where k indexes [not-water, moderate-conf, psw-conservative,
    psw-aggressive].
    """
    lut = np.zeros(256, dtype=np.uint8)
    for bit, values in enumerate([not_water_values or (),
                                  moderate_conf_values or (),
                                  psw_conservative_values or (),
                                  psw_aggressive_values or ()]):
        for v in values:
            lut[int(v)] |= (1 << bit)
    return lut


# WTR-1 classes evaluated for aerosol remapping, in reference iteration
# order; all remap to high-confidence water (dswx_hls.py:1283-1296)
AEROSOL_INPUT_CLASSES = (
    C.WATER_NOT_WATER_CLEAR,
    C.WATER_UNCOLLAPSED_MODERATE_CONF_CLEAR,
    C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLEAR,
    C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR,
)


def apply_aerosol_class_remapping(wtr_1_layer, nir, cloud_layer, fmask,
                                  aerosol_lut):
    """Remap classes to high-confidence water under high aerosol: where
    fmask is in class k's list, WTR-1 equals class k and NIR <= 1000, the
    class becomes high-confidence water and CLOUD bit 3 is set."""
    lutv = torch.as_tensor(aerosol_lut, device=fmask.device)[
        fmask.to(torch.int64)]
    if nir.dtype.is_floating_point:
        nir_ok = nir <= f32(C.AEROSOL_REMAPPING_MAX_NIR)
    else:
        # AEROSOL_REMAPPING_MAX_NIR == 1000.0 exactly
        nir_ok = nir.to(torch.int32) <= int(C.AEROSOL_REMAPPING_MAX_NIR)
    remapped = torch.zeros_like(nir_ok)
    out = wtr_1_layer
    for bit, input_class in enumerate(AEROSOL_INPUT_CLASSES):
        hit = (((lutv >> bit) & 1) == 1) & (wtr_1_layer == input_class) \
            & nir_ok
        out = torch.where(hit, C.WATER_UNCOLLAPSED_HIGH_CONF_CLEAR, out)
        remapped = remapped | hit
    set_bit3 = remapped & (cloud_layer != C.UINT8_FILL_VALUE)
    return out, torch.where(set_bit3, cloud_layer | 8, cloud_layer)


def is_water_class(layer):
    return ((layer >= C.FIRST_UNCOLLAPSED_WATER_CLASS) &
            (layer <= C.LAST_UNCOLLAPSED_WATER_CLASS))


def _nir_gt_lcmask(nir, lcmask_nir):
    """nir > lcmask_nir as the reference decides it: float64-exact for
    integer nir (the exact rational, else the integer bound), plain float32
    for float nir (masking.py:92-109)."""
    if nir.dtype.is_floating_point:
        return nir > f32(lcmask_nir)
    pq = to_exact_fraction(lcmask_nir, SCALAR_MAX_DEN, SCALAR_MAX_NUM)
    if pq is not None:
        p, q = pq
        return nir.to(torch.int32) * q > p
    bound = int_gt_bound(lcmask_nir)
    if bound is None:
        return torch.zeros_like(nir, dtype=torch.bool)
    bound = int(np.clip(bound, -2 ** 31 + 1, 2 ** 31 - 1))
    return nir.to(torch.int32) >= bound


def apply_landcover_and_shadow_masks(interpreted_layer, nir, landcover_mask,
                                     shadow_layer,
                                     hls_thresholds: HlsThresholds):
    """WTR-1 -> WTR-2: demote water classes in terrain shadow and over
    evergreen/developed landcover. ``landcover_mask`` / ``shadow_layer``
    may be None (stage skipped)."""
    out = interpreted_layer
    water = is_water_class(interpreted_layer)

    if shadow_layer is not None:
        shadowed = (shadow_layer == C.SHAD_MASKED) & water
        if landcover_mask is not None:
            shadowed = shadowed & (landcover_mask != C.
                                   DSWX_HLS_LANDCOVER_CLASSES_DICT['water'])
        out = torch.where(shadowed, C.WATER_NOT_WATER_CLEAR, out)

    if landcover_mask is None:
        return out

    lc = landcover_mask.to(torch.int32)
    low_off = C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
        'low_intensity_developed_offset']
    high_off = C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
        'high_intensity_developed_offset']
    evergreen = lc == C.DSWX_HLS_LANDCOVER_CLASSES_DICT['evergreen_forest']
    low_dev = (lc >= low_off) & (lc < low_off + 100)
    high_dev = (lc >= high_off) & (lc < high_off + 100)
    nir_bright = _nir_gt_lcmask(nir, hls_thresholds.lcmask_nir)
    psw = ((interpreted_layer ==
            C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLEAR) |
           (interpreted_layer ==
            C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR))
    # the landcover tests read the *input* interpreted layer, as the
    # reference does (dswx_hls.py:1352-1376)
    demote = ((evergreen & nir_bright & psw) |
              (low_dev & nir_bright & psw) |
              (high_dev & water))
    return torch.where(demote, C.WATER_NOT_WATER_CLEAR, out)


def compute_preliminary_cloud_layer(fmask, mask_adjacent_to_cloud_mode: str):
    """Fmask bit decode -> preliminary CLOUD layer (values 0/1/4/5), uint8.

    Fmask bits: 1 cloud, 2 adjacent-to-cloud/shadow, 3 cloud shadow.
    Cloud shadow (and adjacent, in 'mask' mode) -> 1; cloud -> +4.
    """
    if mask_adjacent_to_cloud_mode not in ('mask', 'ignore', 'cover'):
        raise ValueError(
            f'ERROR mask adjacent to cloud/cloud-shadow mode:'
            f' {mask_adjacent_to_cloud_mode}')
    f = fmask.to(torch.int32)
    shadow = (f & (1 << 3)) != 0
    if mask_adjacent_to_cloud_mode == 'mask':
        shadow = shadow | ((f & (1 << 2)) != 0)
    cloud = (f & (1 << 1)) != 0
    return shadow.to(torch.uint8) + 4 * cloud.to(torch.uint8)


def add_snow_to_cloud_layer(wtr_2_layer, cloud_layer, fmask,
                            mask_adjacent_to_cloud_mode: str):
    """Add the snow/ice class (bit 1) to the CLOUD layer; propagate fill.

    In 'cover' mode, snow is dilated (10 iterations) into clear areas
    adjacent to cloud/shadow, then clear not-snow pixels are dilated back
    (7 iterations) over those of the areas that WTR-2 calls water, and snow
    they reach is dropped.
    """
    f = fmask.to(torch.int32)
    snow_mask = (f & (1 << 4)) != 0
    if mask_adjacent_to_cloud_mode == 'cover':
        clear = cloud_layer == 0
        areas = ((f & (1 << 2)) != 0) & clear
        snow_mask = binary_dilation_masked(snow_mask, 10, mask=areas)
        areas = areas & is_water_class(wtr_2_layer)
        not_masked = binary_dilation_masked((~snow_mask) & clear, 7,
                                            mask=areas)
        snow_mask = snow_mask & ~not_masked
    out = cloud_layer + 2 * snow_mask.to(torch.uint8)
    return torch.where(wtr_2_layer == C.UINT8_FILL_VALUE,
                       C.UINT8_FILL_VALUE, out)


def apply_cloud_masking(wtr_2_layer, cloud_layer):
    """WTR-2 + CLOUD -> WTR: mark cloud (253) and snow (252) pixels.
    Ocean mask and fill pass through from WTR-2."""
    cloudy = (cloud_layer != 0) & (cloud_layer != 8)
    snowy = (cloud_layer == 2) | (cloud_layer == 10)
    out = torch.where(cloudy, C.WTR_CLOUD_MASKED, wtr_2_layer)
    out = torch.where(snowy, C.WTR_SNOW_MASKED, out)
    out = torch.where(wtr_2_layer == C.WTR_OCEAN_MASKED,
                      C.WTR_OCEAN_MASKED, out)
    return torch.where(wtr_2_layer == C.UINT8_FILL_VALUE,
                       C.UINT8_FILL_VALUE, out)
