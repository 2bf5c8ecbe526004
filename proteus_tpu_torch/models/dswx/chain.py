"""The DSWx-HLS per-pixel chain in plain PyTorch: bands in, layers out.

Port of ``proteus_tpu/models/dswx/chain.py:31-159``. It evaluates DIAG ->
WTR-1 -> (aerosol) -> WTR-2 -> CLOUD -> WTR -> BWTR/CONF/BROWSE plus the
coverage counts, one tensor operation at a time. It is the plain twin of
the fused CUDA kernel in ``proteus_tpu_torch.ops.wtr_kernel``: the CPU
path, and the check the kernel is held against on the card.
"""

import dataclasses
from typing import Tuple

import torch

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.core.thresholds import HlsThresholds
from proteus_tpu_torch.models.dswx import masking
from proteus_tpu_torch.models.dswx.browse import compute_browse_array
from proteus_tpu_torch.models.dswx.diagnostics import (
    compute_diagnostic_tests, get_binary_representation)
from proteus_tpu_torch.models.dswx.interpretation import (
    generate_interpreted_layer, get_binary_water_layer, get_confidence_layer)


@dataclasses.dataclass(frozen=True)
class DswxChainConfig:
    """Configuration of the per-pixel chain; the same fields as
    ``proteus_tpu.models.dswx.chain.DswxChainConfig``."""
    thresholds: HlsThresholds = HlsThresholds()
    mask_adjacent_to_cloud_mode: str = 'mask'
    apply_aerosol_class_remapping: bool = True
    aerosol_not_water_fmask_values: Tuple[int, ...] = (224, 160, 96)
    aerosol_moderate_conf_fmask_values: Tuple[int, ...] = (224, 160, 96)
    aerosol_psw_conservative_fmask_values: Tuple[int, ...] = \
        (224, 192, 160, 128, 96)
    aerosol_psw_aggressive_fmask_values: Tuple[int, ...] = \
        (224, 192, 160, 128, 96)
    # ancillary-stage parameters (used by the terrain-shadow and LAND
    # stages, not by the per-pixel chain itself)
    min_slope_angle: float = -5.0
    max_sun_local_inc_angle: float = 40.0
    shadow_masking_algorithm: str = 'sun_local_inc_angle'
    forest_mask_landcover_classes: Tuple[int, ...] = \
        (20, 50, 111, 113, 115, 116, 121, 123, 125, 126)
    # browse options
    exclude_psw_aggressive_in_browse: bool = True
    not_water_in_browse: str = 'white'
    cloud_in_browse: str = 'gray'
    snow_in_browse: str = 'cyan'
    flag_collapse_wtr_classes: bool = C.FLAG_COLLAPSE_WTR_CLASSES

    @classmethod
    def from_reference(cls, cfg):
        """Copy every field, by name, from a ``proteus_tpu`` config."""
        return cls(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cls)})

    def aerosol_lut(self):
        return masking.build_aerosol_fmask_lut(
            self.aerosol_not_water_fmask_values,
            self.aerosol_moderate_conf_fmask_values,
            self.aerosol_psw_conservative_fmask_values,
            self.aerosol_psw_aggressive_fmask_values)


def coverage_counts(invalid_mask, preliminary_cloud, ocean_mask=None):
    """The coverage counters (0-dim int64 tensors), taken on the
    preliminary cloud layer before aerosol (dswx_hls.py:5104-5111)."""
    valid = ~invalid_mask.to(torch.bool)
    if ocean_mask is not None:
        valid = valid & (ocean_mask != 0)
        n_not_ocean = (ocean_mask != 0).sum()
    else:
        n_not_ocean = torch.tensor(valid.numel(), device=valid.device)
    return {'n_valid': valid.sum(),
            'n_cloud_and_valid': ((preliminary_cloud != 0) & valid).sum(),
            'n_not_ocean': n_not_ocean}


def dswx_chain(blue, green, red, nir, swir1, swir2, fmask, invalid_mask,
               config: DswxChainConfig,
               ocean_mask=None, shadow_layer=None, landcover_mask=None,
               compute_browse: bool = True, compute_stats: bool = True):
    """Run the per-pixel DSWx-HLS chain on the inputs' device.

    blue..swir2 : (H, W) int16 unscaled reflectance, or float32
        offset-and-scaled reflectance.
    fmask : (H, W) uint8 HLS Fmask. invalid_mask : (H, W) bool.
    ocean_mask / shadow_layer / landcover_mask : optional (H, W) uint8.

    Returns a dict with 'DIAG' (uint16 pseudo-binary), 'WTR-1', 'WTR-2',
    'WTR', 'BWTR', 'CONF', 'CLOUD', optional 'BROWSE' (uint8), and, with
    ``compute_stats``, the counters of ``coverage_counts``.
    """
    invalid_mask = invalid_mask.to(torch.bool)
    fill = C.UINT8_FILL_VALUE

    diag_decimal = compute_diagnostic_tests(blue, green, red, nir, swir1,
                                            swir2, config.thresholds)
    diag_decimal = torch.where(invalid_mask,
                               C.DIAGNOSTIC_LAYER_NO_DATA_DECIMAL,
                               diag_decimal)
    wtr1 = generate_interpreted_layer(diag_decimal)
    diag = get_binary_representation(diag_decimal)

    if ocean_mask is not None:
        wtr1 = torch.where(ocean_mask == 0, C.WTR_OCEAN_MASKED, wtr1)
    wtr1 = torch.where(invalid_mask, fill, wtr1)
    # the saved WTR-1 layer excludes the aerosol remapping
    # (dswx_hls.py:5251-5266)
    wtr1_product = wtr1

    cloud = masking.compute_preliminary_cloud_layer(
        fmask, config.mask_adjacent_to_cloud_mode)
    stats = (coverage_counts(invalid_mask, cloud, ocean_mask)
             if compute_stats else {})

    if config.apply_aerosol_class_remapping:
        wtr1, cloud = masking.apply_aerosol_class_remapping(
            wtr1, nir, cloud, fmask, config.aerosol_lut())
    wtr2 = masking.apply_landcover_and_shadow_masks(
        wtr1, nir, landcover_mask, shadow_layer, config.thresholds)
    cloud = masking.add_snow_to_cloud_layer(
        wtr2, cloud, fmask, config.mask_adjacent_to_cloud_mode)
    wtr = masking.apply_cloud_masking(wtr2, cloud)

    out = {
        'DIAG': diag,
        'WTR-1': wtr1_product,
        'WTR-2': wtr2,
        'WTR': wtr,
        'BWTR': get_binary_water_layer(wtr),
        'CONF': get_confidence_layer(wtr2, cloud),
        'CLOUD': cloud,
    }
    out.update(stats)
    if compute_browse:
        out['BROWSE'] = compute_browse_array(
            wtr,
            flag_collapse_wtr_classes=config.flag_collapse_wtr_classes,
            exclude_psw_aggressive=config.exclude_psw_aggressive_in_browse,
            set_not_water_to_nodata=(config.not_water_in_browse == 'nodata'),
            set_cloud_to_nodata=(config.cloud_in_browse == 'nodata'),
            set_snow_to_nodata=(config.snow_in_browse == 'nodata'),
            set_ocean_masked_to_nodata=True)
    return out
