"""A frozen copy of the repository's NumPy float64 oracle of the DSWx-HLS
science chain (``tests/oracle.py``), the plain reference of the per-pixel
layers, the shadow and LAND.

An independent re-implementation of the reference SAS semantics
(nasa/PROTEUS dswx_hls.py) which the product is held to bit
for bit. Everything here follows NumPy's default promotion rules on int16
inputs — including int16 overflow wrap in band sums and float64 division
with inf/NaN for zero denominators — because that is what the reference
produces.
"""

import numpy as np
from scipy.ndimage import binary_dilation

FILL = 255
DIAG_NODATA = 32
OCEAN = 254
CLOUDM = 253
SNOWM = 252

INTERP = {
    0b00000: 0, 0b00001: 0, 0b00010: 0, 0b00100: 0, 0b01000: 0,
    0b01111: 1, 0b10111: 1, 0b11011: 1, 0b11101: 1, 0b11110: 1, 0b11111: 1,
    0b00111: 2, 0b01011: 2, 0b01101: 2, 0b01110: 2, 0b10011: 2,
    0b10101: 2, 0b10110: 2, 0b11001: 2, 0b11010: 2, 0b11100: 2,
    0b11000: 3,
    0b00011: 4, 0b00101: 4, 0b00110: 4, 0b01001: 4, 0b01010: 4,
    0b01100: 4, 0b10000: 4, 0b10001: 4, 0b10010: 4, 0b10100: 4,
    DIAG_NODATA: FILL,
}

COLLAPSE = {0: 0, 1: 1, 2: 1, 3: 2, 4: 2,
            OCEAN: OCEAN, SNOWM: SNOWM, CLOUDM: CLOUDM, FILL: FILL}


def diagnostic_tests(blue, green, red, nir, swir1, swir2, t):
    """t: dict-like with wigt..pswt_2_swir2 keys. float64 evaluation."""
    with np.errstate(divide='ignore', invalid='ignore'):
        mndwi = (green - swir1) / (green + swir1)
        mbsrv = green + red
        mbsrn = nir + swir1
        awesh = blue + (2.5 * green) - (1.5 * mbsrn) - (0.25 * swir2)
        ndvi = (nir - red) / (nir + red)

    diag = np.zeros(np.shape(blue), dtype=np.uint16)
    diag[mndwi > t['wigt']] += 1
    diag[mbsrv > mbsrn] += 2
    diag[awesh > t['awgt']] += 4
    diag[(mndwi > t['pswt_1_mndwi']) & (swir1 < t['pswt_1_swir1'])
         & (nir < t['pswt_1_nir']) & (ndvi < t['pswt_1_ndvi'])] += 8
    diag[(mndwi > t['pswt_2_mndwi']) & (blue < t['pswt_2_blue'])
         & (swir1 < t['pswt_2_swir1']) & (swir2 < t['pswt_2_swir2'])
         & (nir < t['pswt_2_nir'])] += 16
    return diag


def interpret(diag):
    out = np.full(diag.shape, FILL, dtype=np.uint8)
    for k, v in INTERP.items():
        out[diag == k] = v
    return out


def binary_representation(diag, nbits=6):
    d = diag.astype(np.int64).copy()
    out = np.zeros(diag.shape, dtype=np.uint16)
    for i in range(nbits):
        d, bit = np.divmod(d, 2)
        if i < 5:
            out += (bit * 10 ** i).astype(np.uint16)
        else:
            out[bit != 0] = 65535
    return out


def preliminary_cloud(fmask, mode):
    out = np.zeros(fmask.shape, dtype=np.uint8)
    out[np.bitwise_and(fmask, 8) == 8] = 1
    if mode == 'mask':
        out[np.bitwise_and(fmask, 4) == 4] = 1
    out[np.bitwise_and(fmask, 2) == 2] += 4
    return out


def aerosol_remap(wtr1, nir, cloud, fmask, lists):
    """lists: dict class->fmask-value list; remaps to class 1. Mutates
    copies and returns them."""
    wtr1 = wtr1.copy()
    cloud = cloud.copy()
    for input_class, fvals in lists.items():
        hit = (np.isin(fmask, fvals) & (wtr1 == input_class)
               & (nir <= 1000.0))
        wtr1[hit] = 1
        sel = hit & (cloud != FILL)
        cloud[sel] |= 8
    return wtr1, cloud


def landcover_shadow_masks(interp_layer, nir, landcover, shadow, t):
    out = interp_layer.copy()
    water = (interp_layer >= 1) & (interp_layer <= 4)
    if shadow is not None and landcover is None:
        out[(shadow == 0) & water] = 0
    elif shadow is not None:
        out[(shadow == 0) & (landcover != 200) & water] = 0
    if landcover is None:
        return out
    psw = (interp_layer == 3) | (interp_layer == 4)
    evergreen = landcover == 201
    low = (landcover >= 0) & (landcover < 100)
    high = (landcover >= 100) & (landcover < 200)
    bright = nir > t['lcmask_nir']
    out[evergreen & bright & psw] = 0
    out[low & bright & psw] = 0
    out[high & water] = 0
    return out


def add_snow(wtr2, cloud, fmask, mode):
    cloud = cloud.copy()
    snow = np.bitwise_and(fmask, 16) == 16
    if mode == 'cover':
        adjacent = np.bitwise_and(fmask, 4) == 4
        areas = adjacent & (cloud == 0)
        snow = binary_dilation(snow, iterations=10, mask=areas)
        areas = areas & (wtr2 >= 1) & (wtr2 <= 4)
        not_masked = (~snow) & (cloud == 0)
        not_masked = binary_dilation(not_masked, iterations=7, mask=areas)
        snow = snow.copy()
        snow[not_masked] = False
    cloud[snow] += 2
    cloud[wtr2 == FILL] = FILL
    return cloud


def apply_cloud(wtr2, cloud):
    wtr = wtr2.copy()
    wtr[(cloud != 0) & (cloud != 8)] = CLOUDM
    wtr[(cloud == 2) | (cloud == 10)] = SNOWM
    wtr[wtr2 == OCEAN] = OCEAN
    wtr[wtr2 == FILL] = FILL
    return wtr


def binary_water(wtr):
    out = wtr.copy()
    for c in range(1, 5):
        out[wtr == c] = 1
    return out


def confidence(wtr2, cloud):
    conf = wtr2.copy()
    cloudy = np.isin(cloud, [1, 3, 4, 5, 6, 7, 9, 11, 12, 13, 14, 15])
    for c in range(5):
        conf[(conf == c) & cloudy] = c + 10
    snowy = cloud == 2
    for c in range(5):
        conf[(conf == c) & snowy] = c + 20
    return conf


def collapse(layer):
    out = np.full_like(layer, FILL)
    for k, v in COLLAPSE.items():
        out[layer == k] = v
    return out


def browse(wtr, collapse_classes=True, exclude_psw_aggressive=False,
           not_water_nodata=False, cloud_nodata=False, snow_nodata=False,
           ocean_nodata=True):
    arr = wtr.copy()
    if exclude_psw_aggressive:
        arr[arr == 4] = 0
    if collapse_classes:
        arr = collapse(arr)
    if not_water_nodata:
        arr[arr == 0] = FILL
    if cloud_nodata:
        arr[arr == CLOUDM] = FILL
    if snow_nodata:
        arr[arr == SNOWM] = FILL
    if ocean_nodata:
        arr[arr == OCEAN] = FILL
    return arr


def opera_shadow(dem, az_deg, elev_deg, min_slope, max_inc,
                 psx=30, psy=30):
    az = np.radians(az_deg)
    zen = np.radians(90 - elev_deg)
    tsv = [np.sin(az) * np.sin(zen), np.cos(az) * np.sin(zen), np.cos(zen)]
    gy, gx = np.gradient(dem)
    tn = [-gx / psx, -gy / -abs(psy), 1]
    norm = np.sqrt(tn[0] ** 2 + tn[1] ** 2 + 1)
    inc = np.degrees(np.arccos(
        (tn[0] * tsv[0] + tn[1] * tsv[1] + tn[2] * tsv[2]) / norm))
    dslope = np.degrees(np.arctan(tn[0] * np.sin(az) + tn[1] * np.cos(az)))
    return (inc <= max_inc) | (~(dslope <= min_slope))


def decimate_sum(image, sy, sx):
    h, w = image.shape
    return image.reshape(h // sy, sy, w // sx, sx).sum(axis=(1, 3))


def landcover_mask(cgls, wc3, mask_type, forest_classes, year=2000):
    thr = {'standard': [6, 3, 7, 3], 'water heavy': [6, 3, 7, 1]}[mask_type]
    water = decimate_sum(np.isin(wc3, [80, 90, 95]).astype(np.uint8), 3, 3)
    urban = decimate_sum((wc3 == 50).astype(np.uint8), 3, 3)
    tree = decimate_sum((wc3 == 10).astype(np.uint8), 3, 3)
    forest = np.zeros_like(tree, dtype=bool)
    for c in (forest_classes or ()):
        forest |= (cgls == c)
    tree = np.where(forest, tree, 0)
    out = np.full(water.shape, FILL, dtype=np.uint8)
    yoff = year - 2000
    out[tree >= thr[0]] = 201
    out[urban >= thr[1]] = 0 + yoff
    out[urban >= thr[2]] = 100 + yoff
    out[water >= thr[3]] = 200
    return out


def full_chain(blue, green, red, nir, swir1, swir2, fmask, invalid,
               thresholds, mode='mask', aerosol_lists=None,
               ocean_mask=None, shadow=None, landcover=None):
    """Replicates the reference orchestrator stage order
    (dswx_hls.py:5089-5368)."""
    diag_dec = diagnostic_tests(blue, green, red, nir, swir1, swir2,
                                thresholds)
    diag_dec[invalid] = DIAG_NODATA
    wtr1 = interpret(diag_dec)
    diag = binary_representation(diag_dec)
    if ocean_mask is not None:
        wtr1[ocean_mask == 0] = OCEAN
    wtr1[invalid] = FILL
    wtr1_product = wtr1.copy()
    cloud = preliminary_cloud(fmask, mode)
    if aerosol_lists is not None:
        wtr1, cloud = aerosol_remap(wtr1, nir, cloud, fmask, aerosol_lists)
    wtr2 = landcover_shadow_masks(wtr1, nir, landcover, shadow, thresholds)
    cloud = add_snow(wtr2, cloud, fmask, mode)
    wtr = apply_cloud(wtr2, cloud)
    bwtr = binary_water(wtr)
    conf = confidence(wtr2, cloud)
    return {'DIAG': diag, 'WTR-1': wtr1_product, 'WTR-2': wtr2, 'WTR': wtr,
            'BWTR': bwtr, 'CONF': conf, 'CLOUD': cloud}
