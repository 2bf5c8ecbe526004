"""EPSG registry tables: the projected/geographic CRS this engine
resolves by code, expressed as parameters for the family modules.

Split out of crs.py (round 5). Every entry cites its product rationale
inline; the reference resolves these implicitly through OSR
(dswx_hls.py:3385-3461).
"""

from .crs_core import (_SHIFT_AMERSFOORT, _SHIFT_CH1903, _SHIFT_CH1903P,
                       _SHIFT_ED50, _SHIFT_NAD27, _SHIFT_OSGB36,
                       _SHIFT_PULKOVO42, _SHIFT_SJTSK, _SHIFT_TIMBALAI,
                       _SHIFT_TOKYO)

# EPSG code -> (standard parallel deg, longitude of origin deg,
#               false easting, false northing, north aspect)
_POLAR_STEREO = {
    3031: (-71.0, 0.0, 0.0, 0.0, False),    # WGS84 Antarctic PS
    3032: (-71.0, 70.0, 6000000.0, 6000000.0, False),  # Australian AAPS
    3413: (70.0, -45.0, 0.0, 0.0, True),    # NSIDC Sea Ice Polar North
    3976: (-70.0, 0.0, 0.0, 0.0, False),    # NSIDC Sea Ice Polar South
    # UPS (variant A: scale factor at the pole instead of a standard
    # parallel) — lat_ts None + k0 appended as the 6th element
    5041: (None, 0.0, 2000000.0, 2000000.0, True, 0.994),   # UPS North
    5042: (None, 0.0, 2000000.0, 2000000.0, False, 0.994),  # UPS South
}


# EPSG code -> (ellipsoid, lat0, lon0, std parallel 1, std parallel 2,
#               false easting, false northing)
_ALBERS = {
    5070: ('GRS80', 23.0, -96.0, 29.5, 45.5, 0.0, 0.0),
    3577: ('GRS80', 0.0, 132.0, -18.0, -36.0, 0.0, 0.0),
}

# EPSG code -> (ellipsoid, lat0, lon0, false easting, false northing)
_LAEA = {
    3035: ('GRS80', 52.0, 10.0, 4321000.0, 3210000.0),
    6931: ('WGS84', 90.0, 0.0, 0.0, 0.0),
    6932: ('WGS84', -90.0, 0.0, 0.0, 0.0),
}

# Lambert Conformal Conic (2SP): the national grids of Canada (Canada
# Atlas Lambert — CDEM/HRDEM deliveries) and France (Lambert-93 — IGN
# products). EPSG code -> (ellipsoid, lat0, lon0, sp1, sp2, fe, fn)
_LCC = {
    3978: ('GRS80', 49.0, -95.0, 49.0, 77.0, 0.0, 0.0),
    2154: ('GRS80', 46.5, 3.0, 49.0, 44.0, 700000.0, 6600000.0),
}

# Mercator: EPSG:3395 (WGS84 World Mercator, ellipsoidal variant A) --
# EPSG code -> (ellipsoid, lon0, k0, fe, fn). EPSG:3857 (Web/"popular
# visualisation pseudo" Mercator: SPHERICAL formulas with R = a on
# geodetic latitude) is handled as its own flag.
_MERC = {
    3395: ('WGS84', 0.0, 1.0, 0.0, 0.0),
}
WEB_MERCATOR_EPSG = 3857

# Lambert Cylindrical Equal Area: EPSG:6933 (NSIDC EASE-Grid 2.0
# global — SMAP/AMSR snow & soil-moisture rasters). EPSG code ->
# (ellipsoid, lat_ts, lon0, fe, fn). The spherical v1 grids
# (3410/3975) remain rejected like every other sphere CRS.
_CEA = {
    6933: ('WGS84', 30.0, 0.0, 0.0, 0.0),
}

# the MODIS sinusoidal grid (no EPSG code; GDAL round-trips it as a
# user-defined SRS): authalic sphere radius used by its custom tuple
MODIS_SPHERE_RADIUS = 6371007.181


# registry projected CRS on classical datums, expressed as family
# tuples (same encoding as CRS.custom) + the _EPSG_TOWGS84 datum shift.
# Grids a legacy DEM/ancillary raster realistically ships in.
_GENERAL = {
    # OSGB36 / British National Grid (EPSG 27700): TM on Airy 1830
    27700: ('tm', 'AIRY1830', 49.0, -2.0, 0.9996012717,
            400000.0, -100000.0),
    # Timbalai 1948 / RSO Borneo (m) (EPSG 29873): Hotine Oblique
    # Mercator variant B (9815) — the EPSG GN7-2 worked example grid
    29873: ('omerc', 'EVEREST1967', 4.0, 115.0,
            53.0 + 18.0 / 60 + 56.9537 / 3600,     # azimuth
            53.0 + 7.0 / 60 + 48.3685 / 3600,      # rectified grid
            0.99984, 590476.87, 442857.65, True),
    # NAD83 / Alaska zone 1 (EPSG 26931): Hotine variant A (9812,
    # false coordinates at the natural origin — PROJ +no_uoff)
    26931: ('omerc', 'GRS80', 57.0, -(133.0 + 40.0 / 60),
            -(36.0 + 52.0 / 60 + 11.6315 / 3600),
            -(36.0 + 52.0 / 60 + 11.6315 / 3600),
            0.9999, 5000000.0, -5000000.0, False),
    # CH1903 / LV03 (EPSG 21781) + CH1903+ / LV95 (EPSG 2056): Swiss
    # Oblique Mercator (EPSG 9815 with azimuth 90 = PROJ somerc)
    21781: ('somerc', 'BESSEL1841',
            46.0 + 57.0 / 60 + 8.66 / 3600,
            7.0 + 26.0 / 60 + 22.50 / 3600,
            1.0, 600000.0, 200000.0),
    2056: ('somerc', 'BESSEL1841',
           46.0 + 57.0 / 60 + 8.66 / 3600,
           7.0 + 26.0 / 60 + 22.50 / 3600,
           1.0, 2600000.0, 1200000.0),
    # S-JTSK / Krovak East North (EPSG 5514): the Czech/Slovak grid,
    # east-north axes (southing/westing negated) as GDAL presents it.
    # EPSG GN7-2 worked example reproduced to cm.
    5514: ('krovak', 'BESSEL1841', 49.5, 24.0 + 50.0 / 60,
           30.0 + 17.0 / 60 + 17.3031 / 3600, 78.5, 0.9999,
           0.0, 0.0),
    # Amersfoort / RD New (EPSG 28992): Oblique (double) Stereographic
    # on Bessel 1841 — the Dutch national grid (EPSG GN7-2 worked
    # example reproduced to mm in tests)
    28992: ('sterea', 'BESSEL1841',
            52.0 + 9.0 / 60 + 22.178 / 3600,
            5.0 + 23.0 / 60 + 15.5 / 3600,
            0.9999079, 155000.0, 463000.0),
    # NZGD2000 / New Zealand Transverse Mercator (EPSG 2193): plain TM
    # on GRS80 (null datum shift, NZGD2000 ~ WGS84)
    2193: ('tm', 'GRS80', 0.0, 173.0, 0.9996, 1600000.0, 10000000.0),
    # WGS 84 / World Equidistant Cylindrical (EPSG 4087) and the
    # deprecated Plate Carree code (EPSG 32662) global grids
    4087: ('eqc', 'WGS84', 0.0, 0.0, 0.0, 0.0, 0.0),
    # deprecated alias of 4087 (identical grid). Parameter-based
    # identification deliberately resolves the shared tuple to
    # non-deprecated 4087 (first dict match), so authority-free
    # WKT/proj4 sourced from 32662 round-trips as 4087; WKT carrying
    # an EPSG AUTHORITY and the GeoTIFF geokey path preserve the
    # original code.
    32662: ('eqc', 'WGS84', 0.0, 0.0, 0.0, 0.0, 0.0),
}
# Pulkovo 1942 / Gauss-Krueger 6-degree zones 2-32 (EPSG 28402-28432):
# TM k0=1 on Krassowsky 1940, FE = zone*1e6 + 500000 (zoned easting)
for _z in range(2, 33):
    _GENERAL[28400 + _z] = ('tm', 'KRASS1940', 0.0, 6.0 * _z - 3.0,
                            1.0, _z * 1e6 + 500000.0, 0.0)

# geographic CRS of the classical datums (lat/lon degrees)
_GEOGRAPHIC_ELL = {
    4326: 'WGS84', 4269: 'GRS80', 4258: 'GRS80',
    4277: 'AIRY1830',      # OSGB36
    4230: 'INTL1924',      # ED50
    4267: 'CLARKE1866',    # NAD27
    4301: 'BESSEL1841',    # Tokyo
    4284: 'KRASS1940',     # Pulkovo 1942
    4149: 'BESSEL1841',    # CH1903
    4150: 'BESSEL1841',    # CH1903+
    4156: 'BESSEL1841',    # S-JTSK
    4289: 'BESSEL1841',    # Amersfoort
    4167: 'GRS80',         # NZGD2000
}

# datum shift to WGS84 per EPSG code (see _SHIFT_* for the EPSG
# transformation each value cites). NAD83/ETRS89/GDA94 datums stay on
# the null transformation (true offsets 1-2 m, below the 30 m grid).
_EPSG_TOWGS84 = {
    27700: _SHIFT_OSGB36, 4277: _SHIFT_OSGB36,
    4230: _SHIFT_ED50,
    4267: _SHIFT_NAD27,
    4301: _SHIFT_TOKYO,
    4284: _SHIFT_PULKOVO42,
    4149: _SHIFT_CH1903, 21781: _SHIFT_CH1903,
    4150: _SHIFT_CH1903P, 2056: _SHIFT_CH1903P,
    29873: _SHIFT_TIMBALAI,
    5514: _SHIFT_SJTSK, 4156: _SHIFT_SJTSK,
    28992: _SHIFT_AMERSFOORT, 4289: _SHIFT_AMERSFOORT,
}
for _z in range(28, 39):    # ED50 / UTM zones 28-38 (EPSG 23028-23038)
    _EPSG_TOWGS84[23000 + _z] = _SHIFT_ED50
for _z in range(3, 23):     # NAD27 / UTM zones 3-22 (EPSG 26703-26722)
    _EPSG_TOWGS84[26700 + _z] = _SHIFT_NAD27
for _z in range(2, 33):     # Pulkovo 1942 / Gauss-Krueger zones
    _EPSG_TOWGS84[28400 + _z] = _SHIFT_PULKOVO42
