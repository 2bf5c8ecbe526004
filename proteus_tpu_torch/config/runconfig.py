"""Runconfig system: defaults + user YAML + CLI precedence.

Mirrors the reference behavior (dswx_hls.py:3575-3814): the default
runconfig ships with the package, a user runconfig is schema-validated and
deep-merged over it (None values in the user file do not override), and
command-line arguments take precedence over both. Per-layer output paths
are derived as {output_dir}/{product_id}_v{version}_B{nn}_{LAYER}.tif for
every layer whose save_* flag is on.
"""

import dataclasses
import glob
import logging
import os
from typing import List, Optional

import yaml

from proteus_tpu_torch.core import constants as C
from proteus_tpu_torch.core.thresholds import HlsThresholds
from proteus_tpu_torch.config import validator
from proteus_tpu_torch.version import VERSION as SOFTWARE_VERSION

logger = logging.getLogger('dswx_hls')

_CONFIG_DIR = os.path.dirname(__file__)
DEFAULT_RUNCONFIG_FILE = os.path.join(_CONFIG_DIR, 'defaults',
                                      'dswx_hls.yaml')
SCHEMA_FILE = os.path.join(_CONFIG_DIR, 'schemas', 'dswx_hls.yaml')


@dataclasses.dataclass
class RunConfigConstants:
    """Processing/browse constants from the runconfig (reference
    RunConfigConstants, dswx_hls.py:321-408)."""
    hls_thresholds: HlsThresholds = dataclasses.field(
        default_factory=HlsThresholds)
    check_ancillary_inputs_coverage: Optional[bool] = None
    apply_ocean_masking: Optional[bool] = None
    apply_aerosol_class_remapping: Optional[bool] = None
    aerosol_not_water_to_high_conf_water_fmask_values: \
        Optional[List[int]] = None
    aerosol_water_moderate_conf_to_high_conf_water_fmask_values: \
        Optional[List[int]] = None
    aerosol_partial_surface_water_conservative_to_high_conf_water_fmask_values: \
        Optional[List[int]] = None
    aerosol_partial_surface_aggressive_to_high_conf_water_fmask_values: \
        Optional[List[int]] = None
    shadow_masking_algorithm: Optional[str] = None
    min_slope_angle: Optional[float] = None
    max_sun_local_inc_angle: Optional[float] = None
    mask_adjacent_to_cloud_mode: Optional[str] = None
    forest_mask_landcover_classes: Optional[List[int]] = None
    ocean_masking_shoreline_distance_km: Optional[float] = None
    browse_image_height: Optional[int] = None
    browse_image_width: Optional[int] = None
    exclude_psw_aggressive_in_browse: Optional[bool] = None
    not_water_in_browse: Optional[str] = None
    cloud_in_browse: Optional[str] = None
    snow_in_browse: Optional[str] = None


def deep_update(main_dict, update_dict):
    """Recursive dict merge; None values in the update do not override."""
    for key, val in update_dict.items():
        if isinstance(val, dict):
            main_dict[key] = deep_update(main_dict.get(key, {}), val)
        elif val is not None:
            main_dict[key] = val
    return main_dict


def load_runconfig(user_runconfig_file=None):
    """Load defaults, then validate + merge the user runconfig (if any)."""
    with open(DEFAULT_RUNCONFIG_FILE) as fh:
        runconfig = yaml.safe_load(fh)

    if user_runconfig_file is not None:
        if not os.path.isfile(user_runconfig_file):
            msg = f'ERROR invalid file {user_runconfig_file}'
            logger.info(msg)
            raise Exception(msg)
        logger.info(f'Input runconfig file: {user_runconfig_file}')
        with open(user_runconfig_file) as fh:
            user = yaml.safe_load(fh)
        logger.info(f'Validating runconfig file: {user_runconfig_file}')
        validator.validate_file(user, SCHEMA_FILE)
        runconfig = deep_update(runconfig, user)
    return runconfig


def runconfig_constants_from_dict(runconfig) -> RunConfigConstants:
    groups = runconfig['runconfig']['groups']
    processing = groups['processing']
    browse = groups['browse_image_group']
    thresholds = groups.get('hls_thresholds')

    rc = RunConfigConstants()
    field_names = {f.name for f in dataclasses.fields(rc)}
    for key, value in {**processing, **browse}.items():
        if key in field_names:
            setattr(rc, key, value)
    rc.hls_thresholds = HlsThresholds.from_dict(thresholds)
    if thresholds:
        logger.info('HLS thresholds:')
        for key, value in thresholds.items():
            logger.info(f'     {key}: {value}')
    return rc


def parse_runconfig_file(user_runconfig_file=None, args=None):
    """Parse a runconfig, optionally updating an argparse.Namespace with
    runconfig-derived values (CLI args keep precedence).

    Returns the RunConfigConstants. Mirrors reference parse_runconfig_file
    (dswx_hls.py:3601-3814) including derived output-layer filenames.
    """
    logger.info(f'Default runconfig file: {DEFAULT_RUNCONFIG_FILE}')
    logger.info(f'YAML schema: {SCHEMA_FILE}')
    runconfig = load_runconfig(user_runconfig_file)
    rc = runconfig_constants_from_dict(runconfig)
    if args is None:
        return rc

    # fill args with runconfig constants where the CLI did not set them
    for f in dataclasses.fields(rc):
        if f.name == 'hls_thresholds':
            continue
        if getattr(args, f.name, None) is None:
            setattr(args, f.name, getattr(rc, f.name))

    groups = runconfig['runconfig']['groups']
    ancillary = groups['dynamic_ancillary_file_group']
    paths = groups['product_path_group']
    input_file_path = groups['input_file_group']['input_file_path']

    product_id = paths.get('product_id') or 'dswx_hls'
    version_num = paths.get('product_version')
    product_version = (f'{version_num:.1f}' if version_num is not None
                       else SOFTWARE_VERSION)
    output_directory = paths.get('output_dir')
    scratch_dir = paths.get('scratch_path')

    if (input_file_path is not None and len(input_file_path) == 1
            and os.path.isdir(input_file_path[0])):
        logger.info(f'input HLS files directory: {input_file_path[0]}')
        args.input_list = glob.glob(
            os.path.join(input_file_path[0], '*.tif'))
    elif input_file_path is not None:
        args.input_list = input_file_path

    runconfig_vars = {
        'dem_file': ancillary.get('dem_file'),
        'dem_file_description': ancillary.get('dem_file_description'),
        'landcover_file': ancillary.get('landcover_file'),
        'landcover_file_description':
            ancillary.get('landcover_file_description'),
        'worldcover_file': ancillary.get('worldcover_file'),
        'worldcover_file_description':
            ancillary.get('worldcover_file_description'),
        'shoreline_shapefile': ancillary.get('shoreline_shapefile'),
        'shoreline_shapefile_description':
            ancillary.get('shoreline_shapefile_description'),
        'scratch_dir': scratch_dir,
        'product_id': product_id,
        'product_version': product_version,
    }
    for var_name, rc_value in runconfig_vars.items():
        cli_value = getattr(args, var_name, None)
        if cli_value is not None and rc_value is not None:
            logger.warning(
                f'command line {var_name} "{cli_value}" has precedence '
                f'over runconfig {var_name} "{rc_value}".')
        elif cli_value is None:
            setattr(args, var_name, rc_value)

    if user_runconfig_file is None:
        return rc

    # derived per-layer output filenames
    processing = groups['processing']
    for layer_name, arg_name in C.LAYER_NAMES_TO_ARGS_DICT.items():
        save_flag = processing.get(
            'save_' + layer_name.lower().replace('-', '_'))
        cli_value = getattr(args, arg_name, None)
        derived = os.path.join(
            output_directory or '.',
            C.layer_file_name(product_id, product_version, layer_name))
        if cli_value is not None and save_flag:
            logger.warning(
                f'command line {arg_name} "{cli_value}" has precedence '
                f'over runconfig {arg_name} "{derived}".')
            continue
        if cli_value is not None or not save_flag:
            continue
        setattr(args, arg_name, derived)

    if groups['browse_image_group'].get('save_browse'):
        cli_value = getattr(args, 'output_browse_image', None)
        derived = os.path.join(output_directory or '.',
                               f'{product_id}_v{product_version}_BROWSE.png')
        if cli_value is not None:
            logger.warning(
                f'command line output_browse_image "{cli_value}" has '
                f'precedence over default "{derived}".')
        else:
            args.output_browse_image = derived

    return rc
