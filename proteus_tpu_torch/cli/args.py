"""Command-line parser for the dswx_hls entry point.

Option-for-option equivalent of the reference CLI
(get_dswx_hls_cli_parser, dswx_hls.py:411-702): every runconfig knob is
also a command-line flag, and CLI values take precedence over the
runconfig.
"""

import argparse


def get_dswx_hls_cli_parser():
    parser = argparse.ArgumentParser(
        description='Generate a DSWx-HLS product from an HLS product',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)

    parser.add_argument('input_list', type=str, nargs='+',
                        help='Input YAML run configuration file or HLS '
                             'product file(s)')

    # ancillary inputs
    parser.add_argument('--dem', dest='dem_file', type=str,
                        help='Input digital elevation model (DEM)')
    parser.add_argument('--dem-description', dest='dem_file_description',
                        type=str, help='Description for the input DEM')
    parser.add_argument('-c', '--landcover', dest='landcover_file',
                        type=str,
                        help='Input Copernicus Land Cover '
                             'Discrete-Classification-map 100m')
    parser.add_argument('--landcover-description',
                        dest='landcover_file_description', type=str,
                        help='Description for the input Copernicus Land '
                             'Cover map')
    parser.add_argument('-w', '--worldcover', dest='worldcover_file',
                        type=str, help='Input ESA WorldCover 10m')
    parser.add_argument('--worldcover-description',
                        dest='worldcover_file_description', type=str,
                        help='Description for the input ESA WorldCover '
                             '10m')
    parser.add_argument('-s', '--shoreline',
                        dest='shoreline_shapefile', type=str,
                        help='NOAA GSHHS shapefile')
    parser.add_argument('--shoreline-shape-description',
                        dest='shoreline_shapefile_description', type=str,
                        help='NOAA GSHHS shapefile description')

    # outputs
    parser.add_argument('-o', '--output-file', dest='output_file',
                        type=str, help='Output DSWx-HLS product (GeoTIFF)')
    parser.add_argument('--wtr', '--interpreted-band',
                        dest='output_interpreted_band', type=str,
                        help='Output interpreted DSWx layer (GeoTIFF)')
    parser.add_argument('--output-rgb', '--output-rgb-file',
                        dest='output_rgb_file', type=str,
                        help='Output RGB reflectance file (GeoTIFF) copied '
                             'from input HLS product.')
    parser.add_argument('--output-infrared-rgb',
                        '--output-infrared-rgb-file',
                        dest='output_infrared_rgb_file', type=str,
                        help='Output infrared SWIR-1, NIR, and Red RGB '
                             'color-composition GeoTIFF file')
    parser.add_argument('--bwtr', '--output-binary-water',
                        dest='output_binary_water', type=str,
                        help='Output binary water mask (GeoTIFF)')
    parser.add_argument('--conf', '--output-confidence-layer',
                        dest='output_confidence_layer', type=str,
                        help='Output confidence layer (GeoTIFF)')
    parser.add_argument('--diag', '--output-diagnostic-layer',
                        dest='output_diagnostic_layer', type=str,
                        help='Output diagnostic test layer file (GeoTIFF)')
    parser.add_argument('--wtr-1', '--output-non-masked-dswx',
                        dest='output_non_masked_dswx', type=str,
                        help='Output non-masked DSWx layer file (GeoTIFF)')
    parser.add_argument('--wtr-2', '--output-shadow-masked-dswx',
                        dest='output_shadow_masked_dswx', type=str,
                        help='Output GeoTIFF file with interpreted layer '
                             'refined using land cover and terrain shadow '
                             'testing')
    parser.add_argument('--land', '--output-land',
                        dest='output_landcover', type=str,
                        help='Output landcover classification file '
                             '(GeoTIFF)')
    parser.add_argument('--shad', '--output-shadow-layer',
                        dest='output_shadow_layer', type=str,
                        help='Output terrain shadow layer file (GeoTIFF)')
    parser.add_argument('--cloud', '--output-cloud-mask',
                        dest='output_cloud_layer', type=str,
                        help='Output cloud/cloud-shadow classification '
                             'file (GeoTIFF)')
    parser.add_argument('--out-dem',
                        '--output-digital-elevation-model',
                        '--output-elevation-layer',
                        dest='output_dem_layer', type=str,
                        help='Output elevation layer file (GeoTIFF)')
    parser.add_argument('--browse', '--output-browse-image',
                        dest='output_browse_image', type=str,
                        help='Output browse image file (png)')

    # browse parameters
    parser.add_argument('--bheight', '--browse-image-height',
                        dest='browse_image_height', type=int,
                        help='Height in pixels for browse image PNG')
    parser.add_argument('--bwidth', '--browse-image-width',
                        dest='browse_image_width', type=int,
                        help='Width in pixels for browse image PNG')
    parser.add_argument('--exclude-psw-aggressive-in-browse',
                        dest='exclude_psw_aggressive_in_browse',
                        action='store_true', default=None,
                        help='Flag to exclude Partial Surface Water '
                             'Aggressive class in the browse image')
    parser.add_argument('--not-water-in-browse',
                        dest='not_water_in_browse', type=str,
                        choices=['white', 'nodata'], default=None,
                        help='How Not Water is displayed in the browse '
                             'image')
    parser.add_argument('--cloud-in-browse', dest='cloud_in_browse',
                        type=str, choices=['gray', 'nodata'], default=None,
                        help='How cloud is displayed in the browse image')
    parser.add_argument('--snow-in-browse', dest='snow_in_browse',
                        type=str, choices=['cyan', 'gray', 'nodata'],
                        default=None,
                        help='How snow is displayed in the browse image')

    # processing parameters
    parser.add_argument('--offset-and-scale-inputs',
                        dest='flag_offset_and_scale_inputs',
                        action='store_true', default=False,
                        help='Offset and scale HLS inputs before '
                             'processing')
    parser.add_argument('--scratch-dir', '--temp-dir', '--temporary-dir',
                        dest='scratch_dir', type=str,
                        help='Scratch (temporary) directory')
    parser.add_argument('--pid', '--product-id', dest='product_id',
                        type=str,
                        help="Product ID saved in the output product's "
                             'metadata')
    parser.add_argument('--product-version', dest='product_version',
                        type=str,
                        help="Product version saved in the output "
                             "product's metadata")
    parser.add_argument('--check-ancillary-inputs-coverage',
                        dest='check_ancillary_inputs_coverage',
                        action='store_true', default=None,
                        help='Check if ancillary inputs cover entirely the '
                             'output product')
    parser.add_argument('--apply-ocean-masking',
                        dest='apply_ocean_masking', action='store_true',
                        default=None, help='Apply ocean masking')
    parser.add_argument('--apply-aerosol-masking',
                        dest='apply_aerosol_class_remapping',
                        action='store_true', default=None,
                        help='Apply aerosol masking')
    parser.add_argument('--shadow-masking-algorithm',
                        dest='shadow_masking_algorithm', type=str,
                        choices=['otsu', 'sun_local_inc_angle'],
                        help='Shadow masking algorithm')
    parser.add_argument('--min-slope-angle', dest='min_slope_angle',
                        type=float, help='Minimum slope angle')
    parser.add_argument('--max-sun-local-inc-angle',
                        dest='max_sun_local_inc_angle', type=float,
                        help='Maximum local-incidence angle')
    parser.add_argument('--mask-adjacent-to-cloud-mode',
                        dest='mask_adjacent_to_cloud_mode', type=str,
                        choices=['mask', 'ignore', 'cover'],
                        help='How areas adjacent to cloud/cloud-shadow are '
                             'handled')
    parser.add_argument('--copernicus-forest-classes',
                        dest='forest_mask_landcover_classes', type=list,
                        help='Copernicus CGLS Land Cover 100m forest '
                             'classes to mask out from the WTR-2 and WTR '
                             'layers')
    parser.add_argument('--ocean-masking-distance-km',
                        dest='ocean_masking_shoreline_distance_km',
                        type=float,
                        help='Ocean masking distance from shoreline in km')
    parser.add_argument('--debug', dest='flag_debug',
                        action='store_true', default=False,
                        help='Activate debug mode')
    parser.add_argument('--log', '--log-file', dest='log_file', type=str,
                        help='Log file')
    parser.add_argument('--full-log-format', dest='full_log_formatting',
                        action='store_true', default=False,
                        help='Enable full formatting of log messages')
    return parser
