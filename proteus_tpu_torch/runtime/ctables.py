"""Color tables for DSWx-HLS product layers.

RGBA palettes matching the reference's GDAL color tables
(dswx_hls.py:1381-1636, 2427-2575). Values are {class: (r, g, b, a)}; the
COG writer stores RGB (TIFF ColorMap has no alpha) and the PNG browse
writer uses alpha for transparency.
"""

from proteus_tpu_torch.core import constants as C

_OPAQUE = 255


def _rgba(rgb):
    if len(rgb) == 4:
        return tuple(rgb)
    return (rgb[0], rgb[1], rgb[2], _OPAQUE)


def get_interpreted_dswx_ctable(
        flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
        layer_name='WTR'):
    ct = {C.WATER_NOT_WATER_CLEAR: _rgba((255, 255, 255))}
    if flag_collapse_wtr_classes:
        ct[C.WATER_COLLAPSED_OPEN_WATER] = _rgba((0, 0, 255))
        ct[C.WATER_COLLAPSED_PARTIAL_SURFACE_WATER] = _rgba((180, 213, 244))
    else:
        ct[C.WATER_UNCOLLAPSED_HIGH_CONF_CLEAR] = _rgba((0, 0, 255))
        ct[C.WATER_UNCOLLAPSED_MODERATE_CONF_CLEAR] = _rgba((95, 127, 255))
        ct[C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLEAR] = \
            _rgba((0, 195, 0))
        ct[C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR] = \
            _rgba((150, 255, 150))
    ct[C.WTR_OCEAN_MASKED] = C.OCEAN_MASKED_RGBA
    if layer_name == 'WTR':
        ct[C.WTR_CLOUD_MASKED] = _rgba((175, 175, 175))
        ct[C.WTR_SNOW_MASKED] = _rgba((0, 255, 255))
    ct[C.UINT8_FILL_VALUE] = C.FILL_VALUE_RGBA
    return ct


def get_browse_ctable(flag_collapse_wtr_classes=C.FLAG_COLLAPSE_WTR_CLASSES,
                      not_water_color='white', cloud_color='gray',
                      snow_color='cyan'):
    if not_water_color not in ('white', 'nodata'):
        raise ValueError(f'not_water_color is {not_water_color}, but must '
                         "be one of 'white' or 'nodata'")
    if cloud_color not in ('gray', 'nodata'):
        raise ValueError(f'cloud_color is {cloud_color}, but must be one '
                         "of 'gray' or 'nodata'")
    if snow_color not in ('cyan', 'gray', 'nodata'):
        raise ValueError(f'snow_color is {snow_color}, but must be one of '
                         "'cyan', 'gray', or 'nodata'")
    ct = get_interpreted_dswx_ctable(flag_collapse_wtr_classes)
    if snow_color == 'gray':
        ct[C.WTR_SNOW_MASKED] = ct[C.WTR_CLOUD_MASKED]
    elif snow_color == 'nodata':
        ct[C.WTR_SNOW_MASKED] = C.FILL_VALUE_RGBA
    if cloud_color == 'nodata':
        ct[C.WTR_CLOUD_MASKED] = C.FILL_VALUE_RGBA
    else:
        ct[C.WTR_CLOUD_MASKED] = _rgba((175, 175, 175))
    if not_water_color == 'nodata':
        ct[C.WATER_NOT_WATER_CLEAR] = C.FILL_VALUE_RGBA
    return ct


def get_cloud_layer_ctable():
    ct = {
        0: _rgba((255, 255, 255)),    # not masked
        1: _rgba((64, 64, 64)),       # cloud shadow
        2: _rgba((0, 255, 255)),      # snow/ice
        3: _rgba((0, 127, 127)),      # shadow + snow
        4: _rgba((192, 192, 192)),    # cloud
        5: _rgba((127, 127, 127)),    # cloud + shadow
        6: _rgba((255, 0, 255)),      # cloud + snow
        7: _rgba((127, 127, 255)),    # cloud + shadow + snow
        8: _rgba((228, 205, 167)),    # aerosol reassignment
        9: _rgba((64, 64, 64)),
        10: _rgba((0, 255, 255)),
        11: _rgba((0, 127, 127)),
        12: _rgba((192, 192, 192)),
        13: _rgba((127, 127, 127)),
        14: _rgba((255, 0, 255)),
        15: _rgba((127, 127, 255)),
        C.CLOUD_OCEAN_MASKED: C.OCEAN_MASKED_RGBA,
        C.UINT8_FILL_VALUE: C.FILL_VALUE_RGBA,
    }
    return ct


def get_landcover_mask_ctable():
    d = C.DSWX_HLS_LANDCOVER_CLASSES_DICT
    ct = {d['evergreen_forest']: _rgba((0, 255, 0)),
          d['water']: _rgba((0, 0, 255))}
    for i in range(100):
        ct[d['low_intensity_developed_offset'] + i] = _rgba((255, 0, 255))
        ct[d['high_intensity_developed_offset'] + i] = _rgba((255, 0, 0))
    ct[d['fill_value']] = C.FILL_VALUE_RGBA
    return ct


def get_binary_mask_ctable():
    return {C.SHAD_MASKED: _rgba((64, 64, 64)),
            C.SHAD_NOT_MASKED: _rgba((255, 255, 255)),
            C.WTR_OCEAN_MASKED: C.OCEAN_MASKED_RGBA,
            C.UINT8_FILL_VALUE: C.FILL_VALUE_RGBA}


def get_binary_water_ctable():
    return {C.WATER_NOT_WATER_CLEAR: _rgba((255, 255, 255)),
            C.BWTR_WATER: _rgba((0, 0, 255)),
            C.WTR_OCEAN_MASKED: C.OCEAN_MASKED_RGBA,
            C.WTR_SNOW_MASKED: _rgba((0, 255, 255)),
            C.WTR_CLOUD_MASKED: _rgba((175, 175, 175)),
            C.UINT8_FILL_VALUE: C.FILL_VALUE_RGBA}


def get_transparency_rgb_vals(top_rgb, bottom_rgb, alpha):
    """Alpha-composite two RGB tuples (reference dswx_hls.py:2545-2575)."""
    if alpha < 0 or alpha > 1:
        raise ValueError('alpha must be in range [0, 1].')
    return tuple(int((alpha * a) + ((1 - alpha) * b))
                 for a, b in zip(top_rgb[:3], bottom_rgb[:3]))


def get_confidence_layer_ctable():
    ct = get_interpreted_dswx_ctable(flag_collapse_wtr_classes=False,
                                     layer_name='WTR')
    not_water = ct[C.WATER_NOT_WATER_CLEAR]
    snow = ct[C.WTR_SNOW_MASKED]
    cloud = ct[C.WTR_CLOUD_MASKED]
    high = ct[C.WATER_UNCOLLAPSED_HIGH_CONF_CLEAR]
    mod = ct[C.WATER_UNCOLLAPSED_MODERATE_CONF_CLEAR]
    psw_c = ct[C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLEAR]
    psw_a = ct[C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLEAR]

    ct[C.WTR_SNOW_MASKED] = _rgba((0, 0, 0))
    ct[C.WTR_CLOUD_MASKED] = _rgba((0, 0, 0))

    alpha = 0.52
    ct[C.WATER_NOT_WATER_CLOUD] = _rgba(
        get_transparency_rgb_vals(cloud, not_water, alpha))
    ct[C.WATER_UNCOLLAPSED_HIGH_CONF_CLOUD] = _rgba(
        get_transparency_rgb_vals(cloud, high, alpha))
    ct[C.WATER_UNCOLLAPSED_MODERATE_CONF_CLOUD] = _rgba(
        get_transparency_rgb_vals(cloud, mod, alpha))
    ct[C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_CLOUD] = \
        _rgba(get_transparency_rgb_vals(cloud, psw_c, alpha))
    ct[C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_CLOUD] = \
        _rgba(get_transparency_rgb_vals(cloud, psw_a, alpha))

    ct[C.WATER_NOT_WATER_SNOW] = snow
    ct[C.WATER_UNCOLLAPSED_HIGH_CONF_SNOW] = snow
    ct[C.WATER_UNCOLLAPSED_MODERATE_CONF_SNOW] = snow
    ct[C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_CONSERVATIVE_SNOW] = snow
    ct[C.WATER_UNCOLLAPSED_PARTIAL_SURFACE_WATER_AGGRESSIVE_SNOW] = snow
    return ct


def to_rgb_map(ctable):
    """RGBA table -> RGB map for the TIFF ColorMap tag."""
    return {k: v[:3] for k, v in ctable.items()}
