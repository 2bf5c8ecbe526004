"""The plain reference of a DSWx-HLS product, from the benchmark's inputs.

It works out again, from the arrays the generator wrote, what the program
derives: the ingest's fill mask and clip, the cubic DEM warp with its
margin, the terrain shadow, the two nearest landcover warps and LAND, the
per-pixel chain, the ten layers and the browse PNG's pixels. It imports
nothing of the program; it takes the frozen oracle and warp beside it.

``work=np.float64`` is the precision the science states (the reference
SAS's float64 NumPy and GDAL's double warps); ``work=np.float32`` is the
control: the warp's interpolation and the shadow's geometry in float32.
"""

import numpy as np

from dswx_bench.reference import oracle
from dswx_bench.reference.warp import warp

LAYERS = ('WTR', 'BWTR', 'CONF', 'DIAG', 'WTR-1', 'WTR-2', 'LAND', 'SHAD',
          'CLOUD', 'DEM')


def check_supported(config):
    """Raise where the configuration asks for what this reference cannot
    work out, so that such a cell stops before its set-up instead of
    running unchecked: ocean masking (no shoreline rasterisation here),
    float inputs scaled on ingest, and shadow algorithms without a
    function in ``SHADOWS``."""
    p = config['processing']
    if p['apply_ocean_masking']:
        raise NotImplementedError('the reference has no ocean mask')
    if config.get('campaign', {}).get('scaled_inputs'):
        raise NotImplementedError('the reference has no scaled float inputs')
    if p['shadow_masking_algorithm'] not in SHADOWS:
        raise NotImplementedError(
            f'the reference has no {p["shadow_masking_algorithm"]!r} shadow')


def grid_layers(inputs, grid, processing, work=np.float64):
    """What a product grid (an acquisition's ``grid``) shares across its
    acquisitions: the warped DEM with its margin and LAND."""
    tile = grid
    gt = tile['geotransform']
    n, zone = tile['size'], tile['utm_zone']
    _, dem, dem_gt = inputs.ancillaries['dem']
    _, cgls, cgls_gt = inputs.ancillaries['cgls']
    _, wc, wc_gt = inputs.ancillaries['worldcover']
    m = processing['dem_margin_px']
    dem_m = warp(dem, dem_gt, zone, gt, n, n, 'cubic', np.nan, margin=m,
                 work=work)
    cgls_w = warp(cgls, cgls_gt, zone, gt, n, n, 'nearest', 255)
    gt3 = (gt[0], gt[1] / 3, 0.0, gt[3], 0.0, gt[5] / 3)
    wc3 = warp(wc, wc_gt, zone, gt3, 3 * n, 3 * n, 'nearest', 0)
    land = oracle.landcover_mask(
        cgls_w, wc3, processing['landcover_mask_type'],
        processing['forest_mask_landcover_classes'],
        year=processing['worldcover_year'])
    return {'dem_m': dem_m, 'LAND': land}


def sun_local_inc_angle(dem_m, azimuth, zenith, processing,
                        work=np.float64):
    """The 'sun_local_inc_angle' shadow (True: not shadow) of the margined
    DEM for the metadata's sun angles, as the program parses them."""
    az = float(azimuth)
    elev = 90 - float(zenith)
    if work == np.float64:
        # arccos of a cosine rounded past 1 is NaN, and NaN is no low
        # incidence: the reference's semantics, without the warning
        with np.errstate(invalid='ignore'):
            return oracle.opera_shadow(dem_m, az, elev,
                                       processing['min_slope_angle'],
                                       processing['max_sun_local_inc_angle'])
    f = np.float32
    azr, zen = f(np.radians(az)), f(np.radians(90 - elev))
    gy, gx = np.gradient(dem_m)
    tn_x, tn_y = -gx / f(30), -gy / f(-30)
    norm = np.sqrt(tn_x ** 2 + tn_y ** 2 + f(1))
    cos_inc = (tn_x * (np.sin(azr) * np.sin(zen))
               + tn_y * (np.cos(azr) * np.sin(zen)) + np.cos(zen)) / norm
    with np.errstate(invalid='ignore'):
        inc = np.degrees(np.arccos(cos_inc))
    dslope = np.degrees(np.arctan(tn_x * np.sin(azr) + tn_y * np.cos(azr)))
    return (inc <= f(processing['max_sun_local_inc_angle'])) | ~(
        dslope <= f(processing['min_slope_angle']))


# the shadow of each ``shadow_masking_algorithm`` this reference can check
SHADOWS = {'sun_local_inc_angle': sun_local_inc_angle}


def product(acquisition, shared, processing, work=np.float64):
    """{layer: array} of one acquisition's product, and 'BROWSE_PNG': the
    browse PNG's palette indices."""
    m = processing['dem_margin_px']
    dem_m = shared['dem_m']
    shadow = SHADOWS[processing['shadow_masking_algorithm']]
    shad = shadow(dem_m, acquisition.azimuth, acquisition.zenith,
                  processing, work)[m:-m, m:-m].astype(np.uint8)
    fmask = acquisition.fmask
    invalid = fmask == 255
    bands = []
    for key in ('blue', 'green', 'red', 'nir', 'swir1', 'swir2'):
        raw = acquisition.bands[key]
        invalid |= raw == -9999
        bands.append(np.clip(raw, 1, None))
    layers = oracle.full_chain(
        *bands, fmask, invalid, processing['hls_thresholds'],
        mode=processing['mask_adjacent_to_cloud_mode'],
        aerosol_lists={int(k): v for k, v in
                       processing['aerosol_lists'].items()}
        if processing['apply_aerosol_class_remapping'] else None,
        shadow=shad, landcover=shared['LAND'])
    browse = oracle.browse(
        layers['WTR'], collapse_classes=True,
        exclude_psw_aggressive=processing['exclude_psw_aggressive_in_browse'],
        not_water_nodata=processing['not_water_in_browse'] == 'nodata',
        cloud_nodata=processing['cloud_in_browse'] == 'nodata',
        snow_nodata=processing['snow_in_browse'] == 'nodata')
    for layer in ('WTR', 'WTR-1', 'WTR-2'):
        layers[layer] = oracle.collapse(layers[layer])
    layers.update(LAND=shared['LAND'], SHAD=shad, DEM=dem_m[m:-m, m:-m],
                  BROWSE=browse,
                  BROWSE_PNG=nearest_resize(browse,
                                            processing['browse_height'],
                                            processing['browse_width']))
    return layers


def nearest_resize(image, height, width):
    """Nearest-neighbour resize, each output pixel's centre mapped into the
    input (PIL's NEAREST)."""
    h, w = image.shape
    rows = np.minimum(((np.arange(height) + 0.5) * (h / height))
                      .astype(np.int64), h - 1)
    cols = np.minimum(((np.arange(width) + 0.5) * (w / width))
                      .astype(np.int64), w - 1)
    return image[rows[:, None], cols[None, :]]
