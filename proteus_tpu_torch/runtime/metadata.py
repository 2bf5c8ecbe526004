"""DSWx-HLS product metadata engine.

Builds the metadata dictionary embedded into every output layer, matching
the reference (dswx_hls.py:3817-4080): product identification, input
dataset sources, the Copernicus LICENSE composition, processing-parameter
echo, and coverage percentages.
"""

from collections import OrderedDict
from datetime import datetime

from proteus_tpu_torch.version import VERSION as SOFTWARE_VERSION

PROCESSING_DATETIME_FORMAT = '%Y-%m-%dT%H:%M:%SZ'

_SENTINEL_LICENSE = (
    'This OPERA DSWx-HLS product contains modified Copernicus'
    ' Sentinel Earth Observation (EO) data.'
    ' Sentinel EO data is provided under COPERNICUS by the'
    ' European Union and ESA; all rights reserved. Users, including'
    ' those who redistribute, adapt, modify, or combine the contents'
    ' of this product, must comply with the terms of the Copernicus'
    ' Sentinel Data License Agreement. ')

_COPERNICUS_DEM_LICENSE = (
    'This OPERA DSWx-HLS product contains modified Copernicus DEM data.'
    ' The Copernicus DEM 30-m and Copernicus DEM 90-m were produced'
    ' using Copernicus WorldDEM-30 © DLR e.V. 2010-2014 and © Airbus'
    ' Defence and Space GmbH 2014-2018, provided under COPERNICUS by'
    ' the European Union and ESA; all rights reserved.'
    ' Users, including those who'
    ' redistribute, adapt, modify, or combine the DEM layer (band 10)'
    ' or derived SHAD layer (band 8), must comply with the terms of'
    ' the Copernicus DEM License Agreement. For additional'
    ' information, please refer to https://doi.org/10.5270/ESA-c5d3d65. ')

_LIABILITY_WITH_COPERNICUS = (
    'The organizations'
    ' in charge of the OPERA project and the Copernicus programme'
    ' by law or by delegation do not assume any legal'
    ' responsibility or liability, whether express or implied,'
    ' arising from any use of this product.')

_LIABILITY_OPERA_ONLY = (
    'The organizations'
    ' in charge of the OPERA project'
    ' by law or by delegation do not assume any legal'
    ' responsibility or liability, whether express or implied,'
    ' arising from any use of this product.')


def get_dswx_metadata_dict(product_id, product_version):
    md = OrderedDict()
    md['PRODUCT_ID'] = product_id
    md['PRODUCT_VERSION'] = (product_version if product_version is not None
                             else SOFTWARE_VERSION)
    md['SOFTWARE_VERSION'] = SOFTWARE_VERSION
    md['PROJECT'] = 'OPERA'
    md['PRODUCT_LEVEL'] = '3'
    md['PRODUCT_TYPE'] = 'DSWx-HLS'
    md['PRODUCT_SOURCE'] = 'HLS'
    md['PROCESSING_DATETIME'] = datetime.now().strftime(
        PROCESSING_DATETIME_FORMAT)
    return md


def populate_dswx_metadata_datasets(md, hls_dataset,
                                    dem_file=None,
                                    dem_file_description=None,
                                    landcover_file=None,
                                    landcover_file_description=None,
                                    worldcover_file=None,
                                    worldcover_file_description=None,
                                    shoreline_shapefile=None,
                                    shoreline_shapefile_description=None):
    import os

    md['HLS_DATASET'] = hls_dataset
    md['DEM_SOURCE'] = (dem_file_description
                        or (os.path.basename(dem_file) if dem_file
                            else 'NOT_PROVIDED'))

    license_str = ''
    has_copernicus = False
    if 'SENTINEL' in md.get('SPACECRAFT_NAME', '').upper():
        has_copernicus = True
        license_str += _SENTINEL_LICENSE
    if 'COPERNICUS DEM' in md['DEM_SOURCE'].upper():
        has_copernicus = True
        license_str += _COPERNICUS_DEM_LICENSE
    license_str += (_LIABILITY_WITH_COPERNICUS if has_copernicus
                    else _LIABILITY_OPERA_ONLY)
    md['LICENSE'] = license_str

    md['LANDCOVER_SOURCE'] = (landcover_file_description
                              or (os.path.basename(landcover_file)
                                  if landcover_file else 'NOT_PROVIDED'))
    md['WORLDCOVER_SOURCE'] = (worldcover_file_description
                               or (os.path.basename(worldcover_file)
                                   if worldcover_file else 'NOT_PROVIDED'))
    md['SHORELINE_SOURCE'] = (shoreline_shapefile_description
                              or (os.path.basename(shoreline_shapefile)
                                  if shoreline_shapefile
                                  else 'NOT_PROVIDED_OR_NOT_USED'))


def populate_dswx_metadata_processing_parameters(
        md, apply_ocean_masking, apply_aerosol_class_remapping,
        aerosol_not_water_to_high_conf_water_fmask_values,
        aerosol_water_moderate_conf_to_high_conf_water_fmask_values,
        aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values,
        aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values,
        shadow_masking_algorithm, min_slope_angle, max_sun_local_inc_angle,
        mask_adjacent_to_cloud_mode, forest_mask_landcover_classes,
        shoreline_shapefile, ocean_masking_shoreline_distance_km):
    md['AEROSOL_CLASS_REMAPPING_ENABLED'] = \
        'TRUE' if apply_aerosol_class_remapping else 'FALSE'

    aerosol_fields = {
        'aerosol_not_water_to_high_conf_water_fmask_values':
            aerosol_not_water_to_high_conf_water_fmask_values,
        'aerosol_water_moderate_conf_to_high_conf_water_fmask_values':
            aerosol_water_moderate_conf_to_high_conf_water_fmask_values,
        'aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values':
            aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values,
        'aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values':
            aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values,
    }
    # note: the reference gates these on forest_mask_landcover_classes (a
    # quirk of dswx_hls.py:4045-4050); matched for metadata parity
    for field, values in aerosol_fields.items():
        if forest_mask_landcover_classes:
            md[field.upper()] = ','.join(str(c) for c in values)
        else:
            md[field.upper()] = 'EMPTY'

    md['SHADOW_MASKING_ALGORITHM'] = shadow_masking_algorithm.upper()
    if shadow_masking_algorithm == 'sun_local_inc_angle':
        md['MIN_SLOPE_ANGLE'] = min_slope_angle
        md['MAX_SUN_LOCAL_INC_ANGLE'] = max_sun_local_inc_angle
    else:
        md['MIN_SLOPE_ANGLE'] = 'NOT_USED'
        md['MAX_SUN_LOCAL_INC_ANGLE'] = 'NOT_USED'

    md['MASK_ADJACENT_TO_CLOUD_MODE'] = mask_adjacent_to_cloud_mode

    if forest_mask_landcover_classes:
        md['FOREST_MASK_LANDCOVER_CLASSES'] = \
            ','.join(str(c) for c in forest_mask_landcover_classes)
    else:
        md['FOREST_MASK_LANDCOVER_CLASSES'] = 'EMPTY'

    md['OCEAN_MASKING_ENABLED'] = 'TRUE' if apply_ocean_masking else 'FALSE'
    md['OCEAN_MASKING_SHORELINE_DISTANCE_KM'] = \
        (ocean_masking_shoreline_distance_km if apply_ocean_masking
         else 'NOT_USED')
