"""End-to-end DSWx-HLS product generation (the library API) in PyTorch.

Port of ``proteus_tpu/runtime/orchestrator.py:70-664``:
``generate_dswx_layers`` keeps the keyword surface of the reference
orchestrator (dswx_hls.py:4610-5417), its stage order and its log lines,
and adds ``device=``. Ingest, coverage checks, shoreline rasterization,
reprojection planning and the product writer run on the host (the port's
copies of the JAX package's host modules); the ocean mask's seaward
buffer, the DEM and landcover warps, the terrain shadow, LAND and the
per-pixel chain run on ``device``. On a CUDA device the per-pixel chain is
the fused CUDA kernels
(K1 or K3, and K2 in 'cover' mode), on the CPU the plain PyTorch chain;
all layers come back to the host once, after the chain.

With ``PROTEUS_TPU_TRACE_DIR`` set, the device chain and the transfer run
under ``runtime.profiling.device_trace`` (a ``torch.profiler`` trace, as
``proteus_tpu/runtime/orchestrator.py:502`` takes a ``jax.profiler`` one).
"""

import logging
import os
import time

import numpy as np
import torch

from proteus_tpu_torch.config.runconfig import parse_runconfig_file
from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.core.thresholds import HlsThresholds
from proteus_tpu_torch.device import synchronize
from proteus_tpu_torch.geo.coverage import check_ancillary_inputs
from proteus_tpu_torch.geo.polygon import create_ocean_mask
from proteus_tpu_torch.geo.warp import warp_to_grid_device, worldcover_year_of
from proteus_tpu_torch.io import hls as hls_io
from proteus_tpu_torch.io.png import geotiff2png
from proteus_tpu_torch.io.vrt import build_vrt
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.models.dswx.landcover import \
    create_landcover_mask_arrays
from proteus_tpu_torch.models.dswx.shadow import (
    compute_opera_shadow_layer_exact, compute_otsu_shadow_layer_exact)
from proteus_tpu_torch.ops.wtr_kernel import (COUNTS, kernel_slices,
                                              wtr_layers)
from proteus_tpu_torch.runtime import ctables
from proteus_tpu_torch.runtime import metadata as md_util
from proteus_tpu_torch.runtime import product_writer as pw
from proteus_tpu_torch.runtime.profiling import StageTimers, device_trace
from proteus_tpu_torch.version import VERSION as SOFTWARE_VERSION

logger = logging.getLogger('dswx_hls')


def _mean_angle(meta_value):
    parts = str(meta_value).split(', ')
    if len(parts) == 2:
        return (float(parts[0]) + float(parts[1])) / 2.0
    return float(parts[0])


def _crop_margin(arr, margin):
    return arr[margin:-margin, margin:-margin]


def generate_dswx_layers(input_list,
                         output_file=None,
                         hls_thresholds=None,
                         dem_file=None,
                         dem_file_description=None,
                         output_interpreted_band=None,
                         output_rgb_file=None,
                         output_infrared_rgb_file=None,
                         output_binary_water=None,
                         output_confidence_layer=None,
                         output_diagnostic_layer=None,
                         output_non_masked_dswx=None,
                         output_shadow_masked_dswx=None,
                         output_landcover=None,
                         output_shadow_layer=None,
                         output_cloud_layer=None,
                         output_dem_layer=None,
                         output_browse_image=None,
                         browse_image_height=None,
                         browse_image_width=None,
                         exclude_psw_aggressive_in_browse=None,
                         not_water_in_browse=None,
                         cloud_in_browse=None,
                         snow_in_browse=None,
                         landcover_file=None,
                         landcover_file_description=None,
                         worldcover_file=None,
                         worldcover_file_description=None,
                         shoreline_shapefile=None,
                         shoreline_shapefile_description=None,
                         flag_offset_and_scale_inputs=False,
                         scratch_dir='.',
                         product_id=None,
                         product_version=SOFTWARE_VERSION,
                         check_ancillary_inputs_coverage=None,
                         apply_ocean_masking=None,
                         apply_aerosol_class_remapping=None,
                         aerosol_not_water_to_high_conf_water_fmask_values=None,
                         aerosol_water_moderate_conf_to_high_conf_water_fmask_values=None,
                         aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=None,
                         aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=None,
                         shadow_masking_algorithm=None,
                         min_slope_angle=None,
                         max_sun_local_inc_angle=None,
                         mask_adjacent_to_cloud_mode=None,
                         forest_mask_landcover_classes=None,
                         ocean_masking_shoreline_distance_km=None,
                         flag_debug=False,
                         device=None):
    """Compute the DSWx-HLS product on ``device`` (a ``torch.device``).
    Returns True on success.

    Parameters match the reference generate_dswx_layers
    (dswx_hls.py:4610-4774); any parameter left as None is filled from the
    default runconfig, as in the reference (:4776-4849).
    """
    if device is None:
        raise ValueError('generate_dswx_layers: device is required '
                         '(see proteus_tpu_torch.device.resolve_device)')
    device = torch.device(device)
    timers = StageTimers()

    # ---- fill None parameters from the default runconfig -----------------
    params = dict(
        hls_thresholds=hls_thresholds,
        check_ancillary_inputs_coverage=check_ancillary_inputs_coverage,
        apply_ocean_masking=apply_ocean_masking,
        apply_aerosol_class_remapping=apply_aerosol_class_remapping,
        aerosol_not_water_to_high_conf_water_fmask_values=
            aerosol_not_water_to_high_conf_water_fmask_values,
        aerosol_water_moderate_conf_to_high_conf_water_fmask_values=
            aerosol_water_moderate_conf_to_high_conf_water_fmask_values,
        aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=
            aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values,
        aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=
            aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values,
        shadow_masking_algorithm=shadow_masking_algorithm,
        min_slope_angle=min_slope_angle,
        max_sun_local_inc_angle=max_sun_local_inc_angle,
        mask_adjacent_to_cloud_mode=mask_adjacent_to_cloud_mode,
        forest_mask_landcover_classes=forest_mask_landcover_classes,
        ocean_masking_shoreline_distance_km=
            ocean_masking_shoreline_distance_km,
        browse_image_height=browse_image_height,
        browse_image_width=browse_image_width,
        exclude_psw_aggressive_in_browse=exclude_psw_aggressive_in_browse,
        not_water_in_browse=not_water_in_browse,
        cloud_in_browse=cloud_in_browse,
        snow_in_browse=snow_in_browse,
    )
    if any(v is None for v in params.values()):
        rc = parse_runconfig_file()
        for key, value in params.items():
            if value is None:
                params[key] = getattr(rc, key)
    hls_thresholds = params.pop('hls_thresholds')
    if isinstance(hls_thresholds, dict):
        hls_thresholds = HlsThresholds.from_dict(hls_thresholds)

    if scratch_dir is None:
        scratch_dir = '.'
    if product_id is None and output_file:
        product_id = os.path.splitext(os.path.basename(output_file))[0]
    elif product_id is None:
        product_id = 'dswx_hls'

    p = params  # short alias

    if p['shadow_masking_algorithm'] not in ('otsu', 'sun_local_inc_angle'):
        msg = (f"ERROR Invalid shadow masking algorithm:"
               f" {p['shadow_masking_algorithm']}")
        logger.error(msg)
        raise ValueError(msg)

    # ---- parameter logging (reference dswx_hls.py:4864-4956) --------------
    ocean_unused = '' if p['apply_ocean_masking'] else ' (unused)'
    logger.info(f'PROTEUS-TPU software version: {SOFTWARE_VERSION}')
    logger.info('input files:')
    logger.info('    HLS product file(s):')
    for f in (input_list if isinstance(input_list, list) else [input_list]):
        logger.info(f'        {f}')
    if output_file:
        logger.info(f'    output multi-band file: {output_file}')
    logger.info(f'    DEM file: {dem_file}')
    logger.info(f'    Copernicus CGLS Land Cover 100m file:'
                f' {landcover_file}')
    logger.info(f'    ESA WorldCover 10m file: {worldcover_file}')
    logger.info(f'    NOAA shoreline shapefile: {shoreline_shapefile}'
                f'{ocean_unused}')
    logger.info('product parameters:')
    logger.info(f'    product ID: {product_id}')
    logger.info(f'    product version: {product_version}')
    logger.info('processing parameters:')
    logger.info(f'    scratch directory: {scratch_dir}')
    logger.info(f"    check ancillary coverage:"
                f" {p['check_ancillary_inputs_coverage']}")
    logger.info(f"    apply ocean masking: {p['apply_ocean_masking']}")
    logger.info(f"    apply aerosol water class remapping:"
                f" {p['apply_aerosol_class_remapping']}")
    logger.info(f"    shadow masking algorithm:"
                f" {p['shadow_masking_algorithm']}")
    logger.info(f"    mask adjacent cloud/cloud-shadow mode:"
                f" {p['mask_adjacent_to_cloud_mode']}")
    logger.info(f"    CGLS Land Cover 100m forest classes:"
                f" {p['forest_mask_landcover_classes']}")

    if not p['apply_ocean_masking']:
        shoreline_shapefile = None
        shoreline_shapefile_description = None

    os.makedirs(scratch_dir, exist_ok=True)

    # ---- ingest ------------------------------------------------------------
    hls_arrays = {}
    offset_dict = {}
    scale_dict = {}
    scratch_files = []
    standalone_output_files = []
    vrt_member_files = []
    dem = None
    shadow_layer = None

    dswx_metadata_dict = md_util.get_dswx_metadata_dict(product_id,
                                                        product_version)

    with timers.stage('ingest (HLS bands)'):
        version = None
        if not isinstance(input_list, list) or len(input_list) == 1:
            success = hls_io.load_hls_product_v1(
                input_list, hls_arrays, offset_dict, scale_dict,
                dswx_metadata_dict, flag_offset_and_scale_inputs,
                flag_debug=flag_debug, device=device)
            if success:
                version = '1.4'
        else:
            success = None
        if success is not True:
            success = hls_io.load_hls_product_v2(
                input_list, hls_arrays, offset_dict, scale_dict,
                dswx_metadata_dict, flag_offset_and_scale_inputs,
                flag_debug=flag_debug, device=device)
            if not success:
                logger.info(f'ERROR could not read file(s): {input_list}')
                return False
            version = '2.0'
    hls_dataset_name = hls_arrays['hls_dataset_name']
    md_util.populate_dswx_metadata_datasets(
        dswx_metadata_dict, hls_dataset_name,
        dem_file=dem_file, dem_file_description=dem_file_description,
        landcover_file=landcover_file,
        landcover_file_description=landcover_file_description,
        worldcover_file=worldcover_file,
        worldcover_file_description=worldcover_file_description,
        shoreline_shapefile=shoreline_shapefile,
        shoreline_shapefile_description=shoreline_shapefile_description)
    md_util.populate_dswx_metadata_processing_parameters(
        dswx_metadata_dict,
        apply_ocean_masking=p['apply_ocean_masking'],
        apply_aerosol_class_remapping=p['apply_aerosol_class_remapping'],
        aerosol_not_water_to_high_conf_water_fmask_values=
            p['aerosol_not_water_to_high_conf_water_fmask_values'],
        aerosol_water_moderate_conf_to_high_conf_water_fmask_values=
            p['aerosol_water_moderate_conf_to_high_conf_water_fmask_values'],
        aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values=
            p['aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values'],
        aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values=
            p['aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values'],
        shadow_masking_algorithm=p['shadow_masking_algorithm'],
        min_slope_angle=p['min_slope_angle'],
        max_sun_local_inc_angle=p['max_sun_local_inc_angle'],
        mask_adjacent_to_cloud_mode=p['mask_adjacent_to_cloud_mode'],
        forest_mask_landcover_classes=p['forest_mask_landcover_classes'],
        shoreline_shapefile=shoreline_shapefile,
        ocean_masking_shoreline_distance_km=
            p['ocean_masking_shoreline_distance_km'])

    spacecraft_name = dswx_metadata_dict['SPACECRAFT_NAME']
    logger.info(f'processing HLS {spacecraft_name[0]}30 dataset'
                f' v.{version}')

    blue = hls_arrays['blue']
    green = hls_arrays['green']
    red = hls_arrays['red']
    nir = hls_arrays['nir']
    swir1 = hls_arrays['swir1']
    swir2 = hls_arrays['swir2']
    fmask = hls_arrays['fmask']
    geotransform = hls_arrays['geotransform']
    projection = hls_arrays['projection']
    length = hls_arrays['length']
    width = hls_arrays['width']
    invalid_array = hls_arrays['invalid_ind_array']
    del hls_arrays

    sun_azimuth_angle = _mean_angle(
        dswx_metadata_dict['MEAN_SUN_AZIMUTH_ANGLE'])
    sun_zenith_angle = _mean_angle(
        dswx_metadata_dict['MEAN_SUN_ZENITH_ANGLE'])
    sun_elevation_angle = 90 - float(sun_zenith_angle)
    logger.info('Sun parameters (from HLS metadata):')
    logger.info(f'    mean azimuth angle: {sun_azimuth_angle}')
    logger.info(f'    mean elevation angle: {sun_elevation_angle}')

    # ---- ancillary coverage checks ----------------------------------------
    with timers.stage('ancillary coverage checks'):
        check_ancillary_inputs(
            p['check_ancillary_inputs_coverage'],
            p['apply_ocean_masking'],
            dem_file, landcover_file, worldcover_file,
            shoreline_shapefile, geotransform, projection, length, width,
            dswx_metadata_dict)

    if 'INPUT_HLS_PRODUCT_SPATIAL_COVERAGE' in dswx_metadata_dict:
        logger.info(f"    input HLS product spatial coverage [%]:"
                    f" {dswx_metadata_dict['INPUT_HLS_PRODUCT_SPATIAL_COVERAGE']}")
    if 'INPUT_HLS_PRODUCT_CLOUD_COVERAGE' in dswx_metadata_dict:
        logger.info(f"    input HLS product cloud coverage [%]:"
                    f" {dswx_metadata_dict['INPUT_HLS_PRODUCT_CLOUD_COVERAGE']}")

    # ---- ocean mask (host rasterization, device buffer) ---------------------
    ocean_mask = None
    if shoreline_shapefile is not None:
        with timers.stage('ocean mask'):
            ocean_mask = create_ocean_mask(
                shoreline_shapefile,
                p['ocean_masking_shoreline_distance_km'], scratch_dir,
                geotransform, projection, length, width, device=device)
            synchronize(device)

    # ---- DEM warp + terrain shadow (device) ---------------------------------
    if dem_file is not None:
        logger.info(f'Preparing DEM file: {dem_file}')
        with timers.stage('DEM warp'):
            dem_with_margin = warp_to_grid_device(
                dem_file, geotransform, projection, length, width,
                resample_algorithm='cubic',
                margin_in_pixels=C.DEM_MARGIN_IN_PIXELS, device=device)
            synchronize(device)
        with timers.stage('terrain shadow'):
            if p['shadow_masking_algorithm'] == 'otsu':
                shadow_with_margin = compute_otsu_shadow_layer_exact(
                    dem_with_margin, sun_azimuth_angle,
                    sun_elevation_angle,
                    pixel_spacing_x=geotransform[1],
                    pixel_spacing_y=geotransform[5])
            else:
                shadow_with_margin = compute_opera_shadow_layer_exact(
                    dem_with_margin, sun_azimuth_angle,
                    sun_elevation_angle, p['min_slope_angle'],
                    p['max_sun_local_inc_angle'])
            synchronize(device)
        shadow_layer = _crop_margin(shadow_with_margin,
                                    C.DEM_MARGIN_IN_PIXELS) \
            .to(torch.uint8).contiguous()
        dem = _crop_margin(dem_with_margin, C.DEM_MARGIN_IN_PIXELS)

    # ---- landcover (device warps + LAND) ------------------------------------
    landcover_mask = None
    if landcover_file is not None and worldcover_file is not None:
        with timers.stage('landcover warps + LAND'):
            logger.info('creating LAND layer combining Copernicus '
                        'Landcover 100m and ESA WorldCover 10m maps')
            if not os.path.isfile(landcover_file):
                logger.error(f'ERROR file not found: {landcover_file}')
            elif not os.path.isfile(worldcover_file):
                logger.error(f'ERROR file not found: {worldcover_file}')
            else:
                cgls = warp_to_grid_device(
                    landcover_file, geotransform, projection, length,
                    width, resample_algorithm='nearest', device=device)
                gt3 = (geotransform[0], geotransform[1] / 3, 0.0,
                       geotransform[3], 0.0, geotransform[5] / 3)
                wc3 = warp_to_grid_device(
                    worldcover_file, gt3, projection, 3 * length,
                    3 * width, resample_algorithm='nearest', device=device)
                year = worldcover_year_of(worldcover_file,
                                          worldcover_file_description)
                landcover_mask = create_landcover_mask_arrays(
                    cgls, wc3, C.LANDCOVER_MASK_TYPE,
                    p['forest_mask_landcover_classes'],
                    worldcover_year=year).contiguous()
                del cgls, wc3
                synchronize(device)

    # ---- the per-pixel chain (device) ---------------------------------------
    chain_config = DswxChainConfig(
        thresholds=hls_thresholds,
        mask_adjacent_to_cloud_mode=p['mask_adjacent_to_cloud_mode'],
        apply_aerosol_class_remapping=p['apply_aerosol_class_remapping'],
        aerosol_not_water_fmask_values=tuple(
            p['aerosol_not_water_to_high_conf_water_fmask_values']),
        aerosol_moderate_conf_fmask_values=tuple(
            p['aerosol_water_moderate_conf_to_high_conf_water_fmask_values']),
        aerosol_psw_conservative_fmask_values=tuple(
            p['aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values']),
        aerosol_psw_aggressive_fmask_values=tuple(
            p['aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values']),
        exclude_psw_aggressive_in_browse=bool(
            p['exclude_psw_aggressive_in_browse']),
        not_water_in_browse=p['not_water_in_browse'],
        cloud_in_browse=p['cloud_in_browse'],
        snow_in_browse=p['snow_in_browse'],
    )

    # int16 bands, or float32 ones with flag_offset_and_scale_inputs
    where = device.type
    if device.type == 'cuda':
        where += ' (cuda kernels ' + ' + '.join(kernel_slices(
            blue.dtype == np.float32, p['mask_adjacent_to_cloud_mode'])) + ')'
    logger.info(f'running the fused DSWx device chain on {where}')
    with device_trace(os.environ.get('PROTEUS_TPU_TRACE_DIR')) as trace:
        with timers.stage('device chain (compile+run)'), \
                trace.annotate('device chain (compile+run)'):
            def to_dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)
            bands = [to_dev(a) for a in (blue, green, red, nir, swir1, swir2)]
            fmask_d = to_dev(fmask)
            invalid_d = to_dev(invalid_array)
            # the layers and the coverage counts, which the kernel adds up
            # as it goes (the reference's jitted stats,
            # orchestrator.py:477-495)
            out = wtr_layers(*bands, fmask_d, invalid_d, chain_config,
                             ocean=ocean_mask, shadow=shadow_layer,
                             landcover=landcover_mask,
                             compute_browse=output_browse_image is not None)
            del bands, fmask_d, invalid_d
            synchronize(device)
        with timers.stage('device->host transfer'), \
                trace.annotate('device->host transfer'):
            # the three counts in one read
            n_valid, n_cloud_and_valid, n_not_ocean = torch.stack(
                [out.pop(k) for k in COUNTS]).tolist()
            out = {k: v.cpu().numpy() for k, v in out.items()}
            if dem is not None:
                dem = dem.cpu().numpy()
                shadow_layer = shadow_layer.cpu().numpy()
            if landcover_mask is not None:
                landcover_mask = landcover_mask.cpu().numpy()

    # ---- coverage statistics -> metadata ------------------------------------
    total_number_of_pixels = length * width
    spatial_coverage = int(100 * float(n_valid) / total_number_of_pixels)
    cloud_coverage = (0 if n_valid == 0
                      else int(100 * float(n_cloud_and_valid) / n_valid))
    spatial_coverage_after_ocean = (
        0 if n_not_ocean == 0
        else int(100 * float(n_valid) / n_not_ocean))
    logger.info('data coverage:')
    logger.info(f'    spatial coverage [%]:  {spatial_coverage}')
    logger.info(f'    spatial coverage after ocean masking [%]:'
                f' {spatial_coverage_after_ocean}')
    logger.info(f'    cloud coverage [%]:  {cloud_coverage}')
    dswx_metadata_dict['SPATIAL_COVERAGE'] = spatial_coverage
    dswx_metadata_dict['SPATIAL_COVERAGE_EXCLUDING_MASKED_OCEAN'] = \
        spatial_coverage_after_ocean
    dswx_metadata_dict['CLOUD_COVERAGE'] = cloud_coverage

    # ---- layer saves (reference order; dswx_hls.py:5138-5397) ---------------
    saves_t0 = time.perf_counter()
    if dem is not None and output_dem_layer is not None:
        pw.save_array(dem, output_dem_layer, dswx_metadata_dict,
                      geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['DEM'],
                      output_files_list=vrt_member_files,
                      no_data_value=np.nan)
    if shadow_layer is not None and output_shadow_layer:
        pw.save_array(shadow_layer, output_shadow_layer,
                      dswx_metadata_dict, geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['SHAD'],
                      output_files_list=vrt_member_files,
                      ctable=ctables.get_binary_mask_ctable())
    if landcover_mask is not None and output_landcover:
        pw.save_array(landcover_mask, output_landcover,
                      dswx_metadata_dict, geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['LAND'],
                      output_files_list=vrt_member_files,
                      ctable=ctables.get_landcover_mask_ctable(),
                      no_data_value=C.DSWX_HLS_LANDCOVER_CLASSES_DICT[
                          'fill_value'])

    invalid_ind = np.where(invalid_array)
    if output_rgb_file:
        pw.save_output_rgb_file(red, green, blue, output_rgb_file,
                                offset_dict, scale_dict,
                                flag_offset_and_scale_inputs,
                                dswx_metadata_dict, geotransform,
                                projection, invalid_ind=invalid_ind,
                                output_files_list=standalone_output_files)
    if output_infrared_rgb_file:
        pw.save_output_rgb_file(swir1, nir, red, output_infrared_rgb_file,
                                offset_dict, scale_dict,
                                flag_offset_and_scale_inputs,
                                dswx_metadata_dict, geotransform,
                                projection, invalid_ind=invalid_ind,
                                output_files_list=standalone_output_files,
                                flag_infrared=True)

    if output_diagnostic_layer:
        pw.save_array(out['DIAG'], output_diagnostic_layer,
                      dswx_metadata_dict, geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['DIAG'],
                      output_files_list=vrt_member_files,
                      no_data_value=C.DIAGNOSTIC_LAYER_NO_DATA_BINARY_REPR)
    if output_non_masked_dswx:
        pw.save_dswx_product(out['WTR-1'], 'WTR-1', output_non_masked_dswx,
                             dswx_metadata_dict, geotransform, projection,
                             output_files_list=vrt_member_files)
    if output_shadow_masked_dswx is not None:
        pw.save_dswx_product(out['WTR-2'], 'WTR-2',
                             output_shadow_masked_dswx,
                             dswx_metadata_dict, geotransform, projection,
                             output_files_list=vrt_member_files)
    if output_interpreted_band:
        pw.save_dswx_product(out['WTR'], 'WTR', output_interpreted_band,
                             dswx_metadata_dict, geotransform, projection,
                             output_files_list=vrt_member_files)

    if output_browse_image:
        browse_ctable = ctables.get_browse_ctable(
            flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
            not_water_color=p['not_water_in_browse'],
            cloud_color=p['cloud_in_browse'],
            snow_color=p['snow_in_browse'])
        browse_geotiff = output_browse_image.replace('.png', '.tif')
        standalone_output_files.append(browse_geotiff)
        pw.save_array(out['BROWSE'], browse_geotiff, dswx_metadata_dict,
                      geotransform, projection,
                      ctable=browse_ctable,
                      no_data_value=C.UINT8_FILL_VALUE)
        geotiff2png(browse_geotiff, output_browse_image,
                    output_height=p['browse_image_height'],
                    output_width=p['browse_image_width'],
                    logger_=logger, rgba_ctable=browse_ctable)
        standalone_output_files.append(output_browse_image)

    if output_cloud_layer:
        pw.save_cloud_layer(out['CLOUD'], output_cloud_layer,
                            dswx_metadata_dict, geotransform, projection,
                            description=C.BAND_DESCRIPTION_DICT['CLOUD'],
                            output_files_list=vrt_member_files)
    if output_binary_water:
        pw.save_binary_water(out['BWTR'], output_binary_water,
                             dswx_metadata_dict, geotransform, projection,
                             description=C.BAND_DESCRIPTION_DICT['BWTR'],
                             output_files_list=vrt_member_files)
    if output_confidence_layer:
        pw.save_array(out['CONF'], output_confidence_layer,
                      dswx_metadata_dict, geotransform, projection,
                      description=C.BAND_DESCRIPTION_DICT['CONF'],
                      output_files_list=vrt_member_files,
                      ctable=ctables.get_confidence_layer_ctable(),
                      no_data_value=C.UINT8_FILL_VALUE)

    if output_file and not output_file.endswith('.vrt'):
        pw.save_dswx_product(out['WTR'], 'WTR', output_file,
                             dswx_metadata_dict, geotransform, projection,
                             bwtr=out['BWTR'], diag=out['DIAG'],
                             wtr_1=out['WTR-1'], wtr_2=out['WTR-2'],
                             land=landcover_mask, shad=shadow_layer,
                             cloud=out['CLOUD'], dem=dem,
                             output_files_list=standalone_output_files)
    elif output_file:
        build_vrt(output_file, vrt_member_files)
        vrt_member_files.append(output_file)
        logger.info(f'file saved: {output_file}')

    saves_elapsed = time.perf_counter() - saves_t0
    logger.info('removing temporary files:')
    for filename in scratch_files:
        if os.path.isfile(filename):
            os.remove(filename)
            logger.info(f'    {filename}')
    timers.add('layer saves (COG encode)', saves_elapsed)
    logger.info('output files:')
    for filename in vrt_member_files + standalone_output_files:
        logger.info(f'    {filename}')
    timers.report()
    return True
