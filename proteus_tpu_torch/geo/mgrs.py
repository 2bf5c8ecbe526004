"""MGRS tile utilities (the port's copy of ``proteus_tpu/geo/mgrs.py``).

Replaces the reference's use of the `mgrs` package + OSR
(get_hls_geographic_boundaries_from_mgrs_tile, core.py:93-155): convert an
MGRS 100 km tile id (e.g. '15RYP' or 'T15RYP') to its UTM lower-left
corner and derive the HLS tile's geographic bounding box (100 km MGRS
square + 4.9 km margin = 109.8 km).
"""

import re

from proteus_tpu_torch.geo.crs import utm_forward, utm_inverse

_COL_LETTER_SETS = ['ABCDEFGH', 'JKLMNPQR', 'STUVWXYZ']
_ROW_LETTERS = 'ABCDEFGHJKLMNPQRSTUV'
_LAT_BANDS = 'CDEFGHJKLMNPQRSTUVWX'


def _band_lat_range(band):
    idx = _LAT_BANDS.index(band)
    lat_min = -80 + 8 * idx
    lat_max = lat_min + 8
    if band == 'X':
        lat_max = 84  # X band is 12 degrees tall
    return lat_min, lat_max


def mgrs_to_utm(tile_name):
    """MGRS 100 km square id -> (zone, is_northern, easting, northing) of
    the square's lower-left (SW) corner."""
    m = re.match(r'^T?(\d{1,2})([C-HJ-NP-X])([A-HJ-NP-Z])([A-HJ-NP-V])$',
                 tile_name.strip().upper())
    if not m:
        raise ValueError(f'invalid MGRS tile name: {tile_name}')
    zone = int(m.group(1))
    band = m.group(2)
    col_letter = m.group(3)
    row_letter = m.group(4)
    if not 1 <= zone <= 60:
        raise ValueError(f'invalid UTM zone in MGRS tile: {tile_name}')

    col_letters = _COL_LETTER_SETS[(zone - 1) % 3]
    if col_letter not in col_letters:
        raise ValueError(
            f'column letter {col_letter!r} invalid for zone {zone}')
    easting = (col_letters.index(col_letter) + 1) * 100000

    row_offset = 0 if zone % 2 == 1 else 5  # even zones start at 'F'
    row_idx = (_ROW_LETTERS.index(row_letter) - row_offset) % 20
    northing_base = row_idx * 100000

    lat_min, lat_max = _band_lat_range(band)
    north = band >= 'N'
    lon0 = zone * 6 - 183
    # northing of the band's equator-most edge at the central meridian
    # (minimum northing within the band, up to hemisphere margins)
    _, band_min_northing = utm_forward(lat_min, lon0, zone, north)
    # resolve the 2,000 km row-letter cycle: smallest candidate >= the
    # band minimum (with a 100 km slack for band-edge squares)
    northing = northing_base
    while northing < band_min_northing - 100000:
        northing += 2000000
    return zone, north, float(easting), float(northing)


def get_hls_geographic_boundaries_from_mgrs_tile(mgrs_tile_name,
                                                 verbose=False):
    """Geographic bbox of an HLS tile (MGRS 100 km square + 4.9 km
    margin). Returns (lat_min, lat_max, lon_min, lon_max) — the same
    contract as the reference (core.py:93-155)."""
    zone, north, x_min, y_min = mgrs_to_utm(mgrs_tile_name)
    lat_min = lat_max = lon_min = lon_max = None
    for ix in range(2):
        for iy in range(2):
            x = x_min - 4.9 * 1000 + ix * 109.8 * 1000
            y = y_min - 4.9 * 1000 + iy * 109.8 * 1000
            lat, lon = utm_inverse(x, y, zone, north)
            lat, lon = float(lat), float(lon)
            if verbose:
                print(f'x: {x}\ny: {y}\nlon: {lon}\nlat: {lat}')
            lat_min = lat if lat_min is None else min(lat_min, lat)
            lat_max = lat if lat_max is None else max(lat_max, lat)
            lon_min = lon if lon_min is None else min(lon_min, lon)
            lon_max = lon if lon_max is None else max(lon_max, lon)
    if verbose:
        print(f'lat_min: {lat_min}\nlat_max: {lat_max}'
              f'\nlon_min: {lon_min}\nlon_max: {lon_max}')
    return lat_min, lat_max, lon_min, lon_max


def mgrs_tile_geotransform(mgrs_tile_name, pixel_size=30.0,
                           margin_m=4900.0):
    """HLS product grid for an MGRS tile: (geotransform, epsg, length,
    width) of the 3660 x 3660 @ 30 m tile (109.8 km incl. margins)."""
    zone, north, x_min, y_min = mgrs_to_utm(mgrs_tile_name)
    size_m = 100000.0 + 2 * margin_m
    n_px = int(round(size_m / pixel_size))
    x0 = x_min - margin_m
    y0 = y_min - margin_m + size_m  # upper-left Y
    epsg = (32600 if north else 32700) + zone
    gt = (x0, pixel_size, 0.0, y0, 0.0, -pixel_size)
    return gt, epsg, n_px, n_px
