"""dswx_hls command-line entry point of the PyTorch port.

Usage: python -m proteus_tpu_torch.cli.dswx_hls <runconfig.yaml>
       python -m proteus_tpu_torch.cli.dswx_hls <HLS band files> [options]

The same arguments as ``proteus_tpu.cli.dswx_hls`` (whose parser and
runconfig merge it reuses). The device comes from
``PROTEUS_TPU_TORCH_DEVICE`` (default ``cuda``); asking for CUDA on a
machine without it is an error, never a silent run on the CPU. A run is
the tracer's span ``sas.cli``, around the product run's ``sas.product``.
"""

import logging
import os

from proteus_tpu_torch.cli.args import get_dswx_hls_cli_parser
from proteus_tpu_torch.config.runconfig import parse_runconfig_file
from proteus_tpu_torch.device import resolve_device
from proteus_tpu_torch.runtime.logging_util import create_logger
from proteus_tpu_torch.runtime.profiling import TRACER

logger = logging.getLogger('dswx_hls')

_RUNCONFIG_SUFFIXES = ('.yaml', '.yml')


def _is_runconfig(path):
    """A runconfig is a YAML text file; everything else is a raster."""
    return os.path.splitext(path)[1].lower() in _RUNCONFIG_SUFFIXES


@TRACER.traced('sas.cli')
def main(argv=None):
    device = resolve_device(os.environ.get('PROTEUS_TPU_TORCH_DEVICE',
                                           'cuda'))
    parser = get_dswx_hls_cli_parser()
    args = parser.parse_args(argv)

    create_logger(args.log_file, args.full_log_formatting)

    runconfigs = [f for f in args.input_list if _is_runconfig(f)]
    if runconfigs and len(args.input_list) > 1:
        parser.error('a runconfig file must be the only input '
                     f'(got {len(args.input_list)} inputs)')

    user_runconfig_file = runconfigs[0] if runconfigs else None
    runconfig_constants = parse_runconfig_file(
        user_runconfig_file=user_runconfig_file, args=args)

    from proteus_tpu_torch.runtime.orchestrator import generate_dswx_layers

    return generate_dswx_layers(
        args.input_list,
        args.output_file,
        hls_thresholds=runconfig_constants.hls_thresholds,
        dem_file=args.dem_file,
        dem_file_description=args.dem_file_description,
        output_interpreted_band=args.output_interpreted_band,
        output_rgb_file=args.output_rgb_file,
        output_infrared_rgb_file=args.output_infrared_rgb_file,
        output_binary_water=args.output_binary_water,
        output_confidence_layer=args.output_confidence_layer,
        output_diagnostic_layer=args.output_diagnostic_layer,
        output_non_masked_dswx=args.output_non_masked_dswx,
        output_shadow_masked_dswx=args.output_shadow_masked_dswx,
        output_landcover=args.output_landcover,
        output_shadow_layer=args.output_shadow_layer,
        output_cloud_layer=args.output_cloud_layer,
        output_dem_layer=args.output_dem_layer,
        output_browse_image=args.output_browse_image,
        browse_image_height=args.browse_image_height,
        browse_image_width=args.browse_image_width,
        exclude_psw_aggressive_in_browse=
            args.exclude_psw_aggressive_in_browse,
        not_water_in_browse=args.not_water_in_browse,
        cloud_in_browse=args.cloud_in_browse,
        snow_in_browse=args.snow_in_browse,
        landcover_file=args.landcover_file,
        landcover_file_description=args.landcover_file_description,
        worldcover_file=args.worldcover_file,
        worldcover_file_description=args.worldcover_file_description,
        shoreline_shapefile=args.shoreline_shapefile,
        shoreline_shapefile_description=
            args.shoreline_shapefile_description,
        flag_offset_and_scale_inputs=args.flag_offset_and_scale_inputs,
        scratch_dir=args.scratch_dir,
        product_id=args.product_id,
        product_version=args.product_version,
        check_ancillary_inputs_coverage=
            args.check_ancillary_inputs_coverage,
        apply_ocean_masking=args.apply_ocean_masking,
        apply_aerosol_class_remapping=args.apply_aerosol_class_remapping,
        aerosol_not_water_to_high_conf_water_fmask_values=
            args.aerosol_not_water_to_high_conf_water_fmask_values,
        aerosol_water_moderate_conf_to_high_conf_water_fmask_values=
            args.aerosol_water_moderate_conf_to_high_conf_water_fmask_values,
        aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=
            args.aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values,
        aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=
            args.aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values,
        shadow_masking_algorithm=args.shadow_masking_algorithm,
        min_slope_angle=args.min_slope_angle,
        max_sun_local_inc_angle=args.max_sun_local_inc_angle,
        mask_adjacent_to_cloud_mode=args.mask_adjacent_to_cloud_mode,
        forest_mask_landcover_classes=args.forest_mask_landcover_classes,
        ocean_masking_shoreline_distance_km=
            args.ocean_masking_shoreline_distance_km,
        flag_debug=args.flag_debug,
        device=device)


if __name__ == '__main__':
    main()
