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
(K1 or K3, and K2 in 'cover' mode), on the CPU the plain PyTorch chain.
Every layer comes back to the host once: DEM, SHAD and LAND as soon as
they are final, the chain's layers after it.

The layers' COGs are written on a save pool of the product run
(``_LayerSaves``): the payloads of DEM, SHAD and LAND start as soon as
their pixels are on the host, every file once the coverage metadata is
known, and the main thread joins them all, in the reference's order,
before it builds the VRT. The files are the same, byte for byte, as
those of the save functions called one after another.

Each product run is the tracer's span ``sas.product``; its stages are
spans under their stage table's names, each layer save a span ``save
<layer>`` on a pool thread under 'layer saves (COG encode)', each early
payload a span ``payload <layer>``, and the wait for the pool
``save.join``. With
``PROTEUS_TPU_TRACE_DIR`` set, the whole run is traced by
``runtime.profiling.device_trace`` (a ``torch.profiler`` trace holding
every stage span, as ``proteus_tpu/runtime/orchestrator.py:502`` takes a
``jax.profiler`` one of the chain).
"""

import functools
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from proteus_tpu_torch.config.runconfig import parse_runconfig_file
from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.core.thresholds import HlsThresholds
from proteus_tpu_torch.device import synchronize, to_device, to_host
from proteus_tpu_torch.geo.coverage import check_ancillary_inputs
from proteus_tpu_torch.geo.polygon import create_ocean_mask
from proteus_tpu_torch.io import hls as hls_io
from proteus_tpu_torch.io.png import geotiff2png
from proteus_tpu_torch.io.vrt import build_vrt
from proteus_tpu_torch.models.dswx import ancillary
from proteus_tpu_torch.models.dswx.chain import DswxChainConfig
from proteus_tpu_torch.ops.wtr_kernel import (COUNTS, kernel_slices,
                                              wtr_layers)
from proteus_tpu_torch.runtime import ctables
from proteus_tpu_torch.runtime import metadata as md_util
from proteus_tpu_torch.runtime import product_writer as pw
from proteus_tpu_torch.runtime.profiling import (COUNTERS, TRACER,
                                                StageTimers, device_trace)
from proteus_tpu_torch.version import VERSION as SOFTWARE_VERSION

logger = logging.getLogger('dswx_hls')


# the save pool's threads: a product's layer files are written side by
# side, the DEFLATE of each still threaded within its own write
_SAVE_WORKERS = min(4, os.cpu_count() or 1)


class _LayerSaves:
    """The save pool of one product run. ``early`` starts a layer's COG
    payload (``pw.layer_payload``: pyramid, predictor, DEFLATE) as soon as
    its pixels are final; ``file`` runs a save (layout, write, full
    validation) once the metadata is final; ``join`` waits for the files
    in the order they were submitted, raises the first failure, and only
    then fills each file's output list, so the lists keep the reference's
    order. Leaving the ``with`` block shuts the pool down and waits for
    its threads, whatever raised. Each task is a span (``payload
    <layer>``, ``save <layer>``) carried from the main thread, with its
    wait in the queue as ``save.queued``; the counters ``save.early`` and
    ``save.pooled`` count the payloads and the files."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(_SAVE_WORKERS,
                                        thread_name_prefix='sas.save')
        self._files = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._pool.shutdown(wait=True, cancel_futures=True)
        return False

    def _submit(self, span, fn):
        return self._pool.submit(TRACER.carry(TRACER.traced(span)(fn),
                                              queued='save.queued'))

    def early(self, layer, array):
        """Start the payload of ``layer``'s host array ``array``; returns
        its future."""
        COUNTERS.add('save.early')
        return self._submit(f'payload {layer}',
                            functools.partial(pw.layer_payload, array))

    def file(self, layer, save, *args, output_files_list=None,
             payload=None, **kwargs):
        """Run ``save(*args, **kwargs)`` on the pool with an output list
        of its own, and with ``payload=`` the result of ``payload`` (an
        ``early`` future) where one is given."""
        COUNTERS.add('save.pooled')
        files = []

        def run():
            if payload is not None:
                # submitted before this task, so running or done already
                kwargs['payload'] = payload.result()
            save(*args, output_files_list=files, **kwargs)
        self._files.append((self._submit(f'save {layer}', run), files,
                            output_files_list))

    def join(self):
        with TRACER.span('save.join'):
            for future, files, output_files_list in self._files:
                future.result()
                if output_files_list is not None:
                    output_files_list.extend(files)
            self._files = []


def _traced_product_run(fn):
    """Run ``fn`` (``generate_dswx_layers``) as the tracer's span
    ``sas.product``, under ``device_trace`` of ``PROTEUS_TPU_TRACE_DIR``
    when it is set."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with device_trace(os.environ.get('PROTEUS_TPU_TRACE_DIR')), \
                TRACER.span('sas.product', item=kwargs.get('product_id')):
            return fn(*args, **kwargs)
    return run


@_traced_product_run
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
    dem = shadow_layer = shadow_host = landcover_host = None

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

    sun_azimuth_angle = ancillary.mean_sun_angle(
        dswx_metadata_dict['MEAN_SUN_AZIMUTH_ANGLE'])
    sun_zenith_angle = ancillary.mean_sun_angle(
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

    # the settings of the ancillary layers and of the per-pixel chain
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
        min_slope_angle=p['min_slope_angle'],
        max_sun_local_inc_angle=p['max_sun_local_inc_angle'],
        shadow_masking_algorithm=p['shadow_masking_algorithm'],
        forest_mask_landcover_classes=tuple(
            p['forest_mask_landcover_classes'] or ()),
        exclude_psw_aggressive_in_browse=bool(
            p['exclude_psw_aggressive_in_browse']),
        not_water_in_browse=p['not_water_in_browse'],
        cloud_in_browse=p['cloud_in_browse'],
        snow_in_browse=p['snow_in_browse'],
    )

    # ---- the product's layer saves run on its own pool -------------------
    with _LayerSaves() as saves:
        payloads = {}

        # ---- DEM warp + terrain shadow (device) -----------------------------
        if dem_file is not None:
            logger.info(f'Preparing DEM file: {dem_file}')
            with timers.stage('DEM warp'):
                dem_with_margin = ancillary.warp_dem(
                    dem_file, geotransform, projection, length, width,
                    device)
                synchronize(device)
            # cropped on the host: a crop's copy would be made contiguous
            # on the device first
            dem = ancillary.crop_margin(to_host(dem_with_margin, 'chain'),
                                        C.DEM_MARGIN_IN_PIXELS)
            if output_dem_layer is not None:
                payloads['DEM'] = saves.early('DEM', dem)
            with timers.stage('terrain shadow'):
                shadow_layer = ancillary.terrain_shadow(
                    dem_with_margin, geotransform, sun_azimuth_angle,
                    sun_zenith_angle, chain_config)
                synchronize(device)
            shadow_host = to_host(shadow_layer, 'chain')
            if output_shadow_layer:
                payloads['SHAD'] = saves.early('SHAD', shadow_host)

        # ---- landcover (device warps + LAND) --------------------------------
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
                    landcover_mask = ancillary.landcover_mask(
                        landcover_file, worldcover_file, geotransform,
                        projection, length, width,
                        chain_config.forest_mask_landcover_classes, device,
                        worldcover_description=worldcover_file_description)
                    synchronize(device)
        if landcover_mask is not None:
            landcover_host = to_host(landcover_mask, 'chain')
            if output_landcover:
                payloads['LAND'] = saves.early('LAND', landcover_host)

        # ---- the per-pixel chain (device) -----------------------------------
        # int16 bands, or float32 ones with flag_offset_and_scale_inputs
        where = device.type
        if device.type == 'cuda':
            where += ' (cuda kernels ' + ' + '.join(kernel_slices(
                blue.dtype == np.float32,
                p['mask_adjacent_to_cloud_mode'])) + ')'
        logger.info(f'running the fused DSWx device chain on {where}')
        with timers.stage('device chain (compile+run)'):
            def to_dev(a):
                return to_device(np.ascontiguousarray(a), device, 'chain')
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
        with timers.stage('device->host transfer'):
            # the three counts in one read
            n_valid, n_cloud_and_valid, n_not_ocean = torch.stack(
                [out.pop(k) for k in COUNTS]).tolist()
            out = {k: to_host(v, 'chain') for k, v in out.items()}

        # ---- coverage statistics -> metadata --------------------------------
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

        # ---- layer saves (reference order; dswx_hls.py:5138-5397) -----------
        # each file on the pool with its own copy of the final metadata
        def md():
            return dict(dswx_metadata_dict)

        with timers.stage('layer saves (COG encode)'):
            def save(layer, array, output, **kwargs):
                saves.file(layer, pw.save_layer, layer, array, output, md(),
                           geotransform, projection,
                           output_files_list=vrt_member_files, **kwargs)

            if dem is not None and output_dem_layer is not None:
                save('DEM', dem, output_dem_layer, payload=payloads['DEM'])
            if shadow_host is not None and output_shadow_layer:
                save('SHAD', shadow_host, output_shadow_layer,
                     payload=payloads['SHAD'])
            if landcover_host is not None and output_landcover:
                save('LAND', landcover_host, output_landcover,
                     payload=payloads['LAND'])

            invalid_ind = np.where(invalid_array)
            if output_rgb_file:
                saves.file('RGB', pw.save_output_rgb_file,
                           red, green, blue, output_rgb_file, offset_dict,
                           scale_dict, flag_offset_and_scale_inputs, md(),
                           geotransform, projection,
                           invalid_ind=invalid_ind,
                           output_files_list=standalone_output_files)
            if output_infrared_rgb_file:
                saves.file('infrared RGB', pw.save_output_rgb_file,
                           swir1, nir, red, output_infrared_rgb_file,
                           offset_dict, scale_dict,
                           flag_offset_and_scale_inputs, md(),
                           geotransform, projection,
                           invalid_ind=invalid_ind,
                           output_files_list=standalone_output_files,
                           flag_infrared=True)

            if output_diagnostic_layer:
                save('DIAG', out['DIAG'], output_diagnostic_layer)
            if output_non_masked_dswx:
                save('WTR-1', out['WTR-1'], output_non_masked_dswx)
            if output_shadow_masked_dswx is not None:
                save('WTR-2', out['WTR-2'], output_shadow_masked_dswx)
            if output_interpreted_band:
                save('WTR', out['WTR'], output_interpreted_band)

            if output_browse_image:
                browse_ctable = ctables.get_browse_ctable(
                    flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
                    not_water_color=p['not_water_in_browse'],
                    cloud_color=p['cloud_in_browse'],
                    snow_color=p['snow_in_browse'])
                browse_geotiff = output_browse_image.replace('.png', '.tif')
                browse_md = md()

                def save_browse(output_files_list):
                    output_files_list.append(browse_geotiff)
                    pw.save_array(out['BROWSE'], browse_geotiff, browse_md,
                                  geotransform, projection,
                                  ctable=browse_ctable,
                                  no_data_value=C.UINT8_FILL_VALUE)
                    geotiff2png(browse_geotiff, output_browse_image,
                                output_height=p['browse_image_height'],
                                output_width=p['browse_image_width'],
                                logger_=logger, rgba_ctable=browse_ctable)
                    output_files_list.append(output_browse_image)
                saves.file('BROWSE', save_browse,
                           output_files_list=standalone_output_files)

            if output_cloud_layer:
                save('CLOUD', out['CLOUD'], output_cloud_layer)
            if output_binary_water:
                save('BWTR', out['BWTR'], output_binary_water)
            if output_confidence_layer:
                save('CONF', out['CONF'], output_confidence_layer)

            if output_file and not output_file.endswith('.vrt'):
                saves.file('product', pw.save_dswx_product,
                           out['WTR'], 'WTR', output_file, md(),
                           geotransform, projection, bwtr=out['BWTR'],
                           diag=out['DIAG'], wtr_1=out['WTR-1'],
                           wtr_2=out['WTR-2'], land=landcover_host,
                           shad=shadow_host, cloud=out['CLOUD'], dem=dem,
                           output_files_list=standalone_output_files)
            saves.join()
            if output_file and output_file.endswith('.vrt'):
                with TRACER.span('save VRT'):
                    build_vrt(output_file, vrt_member_files)
                    vrt_member_files.append(output_file)
                    logger.info(f'file saved: {output_file}')

    logger.info('removing temporary files:')
    for filename in scratch_files:
        if os.path.isfile(filename):
            os.remove(filename)
            logger.info(f'    {filename}')
    logger.info('output files:')
    for filename in vrt_member_files + standalone_output_files:
        logger.info(f'    {filename}')
    timers.report()
    return True
