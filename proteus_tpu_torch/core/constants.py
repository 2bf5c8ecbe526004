"""DSWx-HLS science constants.

These values define the DSWx-HLS product and must match the reference SAS
exactly (reference: nasa/PROTEUS src/proteus/dswx_hls.py:26-271). They are
facts of the product specification (USGS DSWE heritage), not code: class ids,
bit encodings, the 32-entry diagnostic-interpretation table, color tables, and
band metadata.
"""

import numpy as np

# --- module-level behavior flags (dswx_hls.py:26,31,41) ---------------------
FLAG_COLLAPSE_WTR_CLASSES = True
FLAG_CLIP_NEGATIVE_REFLECTANCE = True
LANDCOVER_MASK_TYPE = 'standard'

# Buffer for the antimeridian crossing test (33 arcsec ~ 1 km)
# (dswx_hls.py:34)
ANTIMERIDIAN_CROSSING_RIGHT_SIDE_TEST_BUFFER = 33 * 0.0002777

# ancillary latitude coverage limits (dswx_hls.py:36-39)
LANDCOVER_LAT_MAX = 80
LANDCOVER_LAT_MIN = -60
WORLDCOVER_LAT_MAX = 84
WORLDCOVER_LAT_MIN = -60

# HLS reflectance scaling (dswx_hls.py:45-46). Thresholds are evaluated over
# unscaled (integer) reflectance values.
SCALE_FACTOR = 0.0001
AEROSOL_REMAPPING_MAX_NIR = 0.1 / SCALE_FACTOR  # == 1000.0 exactly in f64

COMPARE_DSWX_HLS_PRODUCTS_ERROR_TOLERANCE = 1e-6

UINT8_FILL_VALUE = 255
OCEAN_MASKED_RGBA = (0, 0, 127, 0)
FILL_VALUE_RGBA = (0, 0, 0, 0)

# Extra DEM margin for interpolation near tile edges (dswx_hls.py:58)
DEM_MARGIN_IN_PIXELS = 50

# --- HLS band naming (dswx_hls.py:62-92) -------------------------------------
# order matters: ingest iterates in this order (blue first => metadata source)
HLS_BAND_KEYS = ('blue', 'green', 'red', 'nir', 'swir1', 'swir2', 'fmask')

L30_V1_BAND_DICT = {'blue': 'band02', 'green': 'band03', 'red': 'band04',
                    'nir': 'band05', 'swir1': 'band06', 'swir2': 'band07',
                    'fmask': 'QA'}
S30_V1_BAND_DICT = {'blue': 'band02', 'green': 'band03', 'red': 'band04',
                    'nir': 'band8A', 'swir1': 'band11', 'swir2': 'band12',
                    'fmask': 'QA'}
L30_V2_BAND_DICT = {'blue': 'B02', 'green': 'B03', 'red': 'B04',
                    'nir': 'B05', 'swir1': 'B06', 'swir2': 'B07',
                    'fmask': 'Fmask'}
S30_V2_BAND_DICT = {'blue': 'B02', 'green': 'B03', 'red': 'B04',
                    'nir': 'B8A', 'swir1': 'B11', 'swir2': 'B12',
                    'fmask': 'Fmask'}

# --- diagnostic layer ---------------------------------------------------------
DIAGNOSTIC_LAYER_NO_DATA_DECIMAL = 0b100000  # 32
DIAGNOSTIC_LAYER_NO_DATA_BINARY_REPR = 65535

# 5-bit diagnostic mask -> interpreted class (dswx_hls.py:97-143).
# Classes: 0 not-water, 1 high-conf water, 2 moderate-conf water,
# 3 partial surface water conservative, 4 partial surface water aggressive.
INTERPRETED_DSWX_BAND_DICT = {
    # Not water
    0b00000: 0, 0b00001: 0, 0b00010: 0, 0b00100: 0, 0b01000: 0,
    # Water - high confidence
    0b01111: 1, 0b10111: 1, 0b11011: 1, 0b11101: 1, 0b11110: 1, 0b11111: 1,
    # Water - moderate confidence
    0b00111: 2, 0b01011: 2, 0b01101: 2, 0b01110: 2, 0b10011: 2,
    0b10101: 2, 0b10110: 2, 0b11001: 2, 0b11010: 2, 0b11100: 2,
    # Partial surface water conservative
    0b11000: 3,
    # Partial surface water aggressive
    0b00011: 4, 0b00101: 4, 0b00110: 4, 0b01001: 4, 0b01010: 4,
    0b01100: 4, 0b10000: 4, 0b10001: 4, 0b10010: 4, 0b10100: 4,
    # Fill value
    DIAGNOSTIC_LAYER_NO_DATA_DECIMAL: UINT8_FILL_VALUE,
}


def build_interpretation_lut():
    """33-entry uint8 LUT: diag decimal value (0..32) -> interpreted class.

    Values outside the table map to UINT8_FILL_VALUE (the reference fills the
    output with 255 and only assigns known keys, dswx_hls.py:1702-1705).
    """
    lut = np.full(DIAGNOSTIC_LAYER_NO_DATA_DECIMAL + 1, UINT8_FILL_VALUE,
                  dtype=np.uint8)
    for key, value in INTERPRETED_DSWX_BAND_DICT.items():
        lut[key] = value
    return lut


# --- water classes (dswx_hls.py:146-215) -------------------------------------
WATER_NOT_WATER_CLEAR = 0

WATER_COLLAPSED_OPEN_WATER = 1
WATER_COLLAPSED_PARTIAL_SURFACE_WATER = 2

WATER_UNCOLLAPSED_HIGH_CONF_CLEAR = 1
WATER_UNCOLLAPSED_MODERATE_CONF_CLEAR = 2
WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLEAR = 3
WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR = 4

FIRST_UNCOLLAPSED_WATER_CLASS = 1
LAST_UNCOLLAPSED_WATER_CLASS = 4

WTR_SNOW_MASKED = 252
WTR_CLOUD_MASKED = 253
WTR_OCEAN_MASKED = 254

SHAD_NOT_MASKED = 1
SHAD_MASKED = 0

BWTR_WATER = 1
CLOUD_OCEAN_MASKED = 254

# CONF layer class offsets
WATER_NOT_WATER_CLOUD = 10
WATER_UNCOLLAPSED_HIGH_CONF_CLOUD = 11
WATER_UNCOLLAPSED_MODERATE_CONF_CLOUD = 12
WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLOUD = 13
WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLOUD = 14

WATER_NOT_WATER_SNOW = 20
WATER_UNCOLLAPSED_HIGH_CONF_SNOW = 21
WATER_UNCOLLAPSED_MODERATE_CONF_SNOW = 22
WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_SNOW = 23
WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_SNOW = 24

# CLOUD-layer values that mark a pixel as cloud-covered in the CONF layer
# (dswx_hls.py:1793-1794). Cloud has precedence over snow; snow is only the
# exact value 2 (snow with no other bits and no aerosol bit... value 10 is
# aerosol+snow and counts as cloud per the list below).
CONF_CLOUD_VALUES = (1, 3, 4, 5, 6, 7, 9, 11, 12, 13, 14, 15)
CONF_SNOW_VALUE = 2

# --- class collapsing (dswx_hls.py:201-215) ----------------------------------
COLLAPSE_WTR_CLASSES_DICT = {
    WATER_NOT_WATER_CLEAR: WATER_NOT_WATER_CLEAR,
    WATER_UNCOLLAPSED_HIGH_CONF_CLEAR: WATER_COLLAPSED_OPEN_WATER,
    WATER_UNCOLLAPSED_MODERATE_CONF_CLEAR: WATER_COLLAPSED_OPEN_WATER,
    WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLEAR:
        WATER_COLLAPSED_PARTIAL_SURFACE_WATER,
    WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR:
        WATER_COLLAPSED_PARTIAL_SURFACE_WATER,
    WTR_OCEAN_MASKED: WTR_OCEAN_MASKED,
    WTR_SNOW_MASKED: WTR_SNOW_MASKED,
    WTR_CLOUD_MASKED: WTR_CLOUD_MASKED,
    UINT8_FILL_VALUE: UINT8_FILL_VALUE,
}

COLLAPSABLE_LAYERS_LIST = ['WTR', 'WTR-1', 'WTR-2']


def build_collapse_lut():
    """256-entry uint8 LUT implementing the WTR class collapse.

    The reference initializes the output to fill and assigns the 9 mapped
    values (dswx_hls.py:2593-2598); any other input value becomes fill.
    """
    lut = np.full(256, UINT8_FILL_VALUE, dtype=np.uint8)
    for original, new in COLLAPSE_WTR_CLASSES_DICT.items():
        lut[original] = new
    return lut


# --- product layers (dswx_hls.py:217-241) ------------------------------------
BAND_DESCRIPTION_DICT = {
    'WTR': 'Water classification (WTR)',
    'BWTR': 'Binary Water (BWTR)',
    'CONF': 'Confidence classification (CONF)',
    'DIAG': 'Diagnostic layer (DIAG)',
    'WTR-1': 'Interpretation of diagnostic layer into water classes (WTR-1)',
    'WTR-2': 'Interpreted layer refined using land cover and terrain shadow '
             'testing (WTR-2)',
    'LAND': 'Land cover classification (LAND)',
    'SHAD': 'Terrain shadow layer (SHAD)',
    'CLOUD': 'Input HLS Fmask cloud/cloud-shadow classification (CLOUD)',
    'DEM': 'Digital elevation model (DEM)',
}

LAYER_NAMES_TO_ARGS_DICT = {
    'WTR': 'output_interpreted_band',
    'BWTR': 'output_binary_water',
    'CONF': 'output_confidence_layer',
    'DIAG': 'output_diagnostic_layer',
    'WTR-1': 'output_non_masked_dswx',
    'WTR-2': 'output_shadow_masked_dswx',
    'LAND': 'output_landcover',
    'SHAD': 'output_shadow_layer',
    'CLOUD': 'output_cloud_layer',
    'DEM': 'output_dem_layer',
    'RGB': 'output_rgb_file',
    'INFRARED_RGB': 'output_infrared_rgb_file',
}

# each layer's band number, B01-B12, in the order above
LAYER_BAND_NUMBERS = {name: i + 1
                      for i, name in enumerate(LAYER_NAMES_TO_ARGS_DICT)}


def layer_file_name(product_id, product_version, layer_name):
    """The file name of a product's layer:
    ``{product_id}_v{version}_B{nn}_{layer}.tif``."""
    return (f'{product_id}_v{product_version}'
            f'_B{LAYER_BAND_NUMBERS[layer_name]:02}_{layer_name}.tif')

METADATA_FIELDS_TO_COPY_FROM_HLS_LIST = [
    'MEAN_SUN_AZIMUTH_ANGLE', 'MEAN_SUN_ZENITH_ANGLE',
    'MEAN_VIEW_AZIMUTH_ANGLE', 'MEAN_VIEW_ZENITH_ANGLE',
    'NBAR_SOLAR_ZENITH', 'ACCODE',
]

# --- landcover classes (dswx_hls.py:252-271) ----------------------------------
DSWX_HLS_LANDCOVER_CLASSES_DICT = {
    'low_intensity_developed_offset': 0,     # + (year-2000): classes 0-99
    'high_intensity_developed_offset': 100,  # + (year-2000): classes 100-199
    'water': 200,
    'evergreen_forest': 201,
    'fill_value': UINT8_FILL_VALUE,
}

# threshold list: [evergreen, low-intensity dev, high-intensity dev, water]
LANDCOVER_THRESHOLD_DICT = {'standard': [6, 3, 7, 3],
                            'water heavy': [6, 3, 7, 1]}

# WorldCover 10m class codes used by the LAND mask builder
# (dswx_hls.py:1000-1020)
WORLDCOVER_WATER_CLASSES = (80, 90, 95)  # permanent water, wetland, mangrove
WORLDCOVER_URBAN_CLASS = 50              # built-up
WORLDCOVER_TREE_CLASS = 10               # tree cover
