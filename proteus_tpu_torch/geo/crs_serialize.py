"""CRS serialization and user-defined-projection dispatch: WKT and
proj4 emission/parsing helpers, linear units, and the custom-family
forward/inverse dispatch tables.

Split out of crs.py (round 5). The WKT/proj4 forms round-trip exactly
(repr floats) — the contract tests/test_geo.py pins against GDAL's
encodings of the same SRS.
"""

import re

import numpy as np

from .crs_core import (_ELLIPSOIDS, _effective_shift, _ensure_ellipsoid)
from .crs_tm import tm_forward_general, tm_inverse_general
from .crs_conformal import (krovak_forward, krovak_inverse,
                            lcc_forward, lcc_inverse,
                            mercator_forward, mercator_inverse,
                            omerc_forward, omerc_inverse,
                            polar_stereo_forward, polar_stereo_inverse,
                            somerc_forward, somerc_inverse,
                            sterea_forward, sterea_inverse)
from .crs_equal_area import (albers_forward, albers_inverse,
                             cea_forward, cea_inverse,
                             eqc_forward, eqc_inverse,
                             laea_forward, laea_inverse,
                             sinusoidal_forward, sinusoidal_inverse)

_NUM_RE = r'([-+]?[\d.]+(?:[eE][-+]?\d+)?)'


def _proj4_param(proj4, key, default=0.0):
    m = re.search(rf'\+{key}={_NUM_RE}', proj4)
    return float(m.group(1)) if m else default


# projected linear units (metres per unit). US State Plane grids ship
# in feet; the reference accepts them through OSR (dswx_hls.py:3385).
_FOOT = 0.3048                    # international foot (EPSG 9002)
_US_FOOT = 1200.0 / 3937.0        # US survey foot (EPSG 9003)
_UNIT_GEOKEY = {9001: 1.0, 9002: _FOOT, 9003: _US_FOOT}
_UNIT_WKT_NAME = {1.0: ('metre', '1'), _FOOT: ('foot', '0.3048'),
                  _US_FOOT: ('US survey foot', '0.30480060960121924')}


def _snap_unit(factor):
    """Snap a parsed linear-unit factor onto the exact registry value
    (WKT/geokey files round-trip through decimal text)."""
    factor = float(factor)
    for exact in (1.0, _FOOT, _US_FOOT):
        if abs(factor - exact) < 1e-12:
            return exact
    if not (factor > 0 and np.isfinite(factor)):
        raise ValueError(f'invalid projected linear unit: {factor!r}')
    return factor


# known geographic CS geokey codes -> ellipsoid of their datum (the
# datum shift itself is the null transformation, like the named CRS)
_GEOGCS_ELL = {
    4326: 'WGS84', 4322: 'WGS84',
    4269: 'GRS80', 4258: 'GRS80', 4283: 'GRS80', 4171: 'GRS80',
    4617: 'GRS80', 4759: 'GRS80', 4167: 'GRS80',
    # classical datums (their Helmert shifts live in _EPSG_TOWGS84)
    4277: 'AIRY1830', 4230: 'INTL1924', 4267: 'CLARKE1866',
    4301: 'BESSEL1841', 4284: 'KRASS1940',
    4149: 'BESSEL1841', 4150: 'BESSEL1841', 4156: 'BESSEL1841',
}



_WKT_PS_TEMPLATE = (
    'PROJCS["{name}",GEOGCS["WGS 84",'
    'DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563,'
    'AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]],PROJECTION["Polar_Stereographic"],'
    'PARAMETER["latitude_of_origin",{lat_ts}],'
    'PARAMETER["central_meridian",{lon0}],'
    'PARAMETER["false_easting",{fe}],'
    'PARAMETER["false_northing",{fn}],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AUTHORITY["EPSG","{epsg}"]]')

_PS_NAMES = {
    3031: 'WGS 84 / Antarctic Polar Stereographic',
    3032: 'WGS 84 / Australian Antarctic Polar Stereographic',
    3413: 'WGS 84 / NSIDC Sea Ice Polar Stereographic North',
    3976: 'WGS 84 / NSIDC Sea Ice Polar Stereographic South',
}


_WKT_UTM_TEMPLATE = (
    'PROJCS["WGS 84 / UTM zone {zone}{ns}",GEOGCS["WGS 84",'
    'DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563,'
    'AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]],PROJECTION["Transverse_Mercator"],'
    'PARAMETER["latitude_of_origin",0],'
    'PARAMETER["central_meridian",{lon0}],'
    'PARAMETER["scale_factor",0.9996],'
    'PARAMETER["false_easting",500000],'
    'PARAMETER["false_northing",{fn}],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
    'AUTHORITY["EPSG","{epsg}"]]')

_WKT_WGS84 = (
    'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
    '298.257223563,AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AXIS["Latitude",NORTH],AXIS["Longitude",EAST],'
    'AUTHORITY["EPSG","4326"]]')

_GEOGCS_GRS80 = (
    'GEOGCS["{datum_name}",DATUM["{datum_wkt}",'
    'SPHEROID["GRS 1980",6378137,298.257222101,'
    'AUTHORITY["EPSG","7019"]],AUTHORITY["EPSG","{datum_auth}"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]]')

_WKT_GEO_GRS80_TEMPLATE = (
    _GEOGCS_GRS80 + ',AXIS["Latitude",NORTH],AXIS["Longitude",EAST],'
    'AUTHORITY["EPSG","{epsg}"]]')

_WKT_UTM_GRS80_TEMPLATE = (
    'PROJCS["{datum_name} / UTM zone {zone}N",' + _GEOGCS_GRS80
    + ',AUTHORITY["EPSG","{geogcs_auth}"]],'
    'PROJECTION["Transverse_Mercator"],'
    'PARAMETER["latitude_of_origin",0],'
    'PARAMETER["central_meridian",{lon0}],'
    'PARAMETER["scale_factor",0.9996],'
    'PARAMETER["false_easting",500000],'
    'PARAMETER["false_northing",0],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
    'AUTHORITY["EPSG","{epsg}"]]')

_GEOGCS_WGS84_FRAG = (
    'GEOGCS["WGS 84",DATUM["WGS_1984",SPHEROID["WGS 84",6378137,'
    '298.257223563,AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]]')

_GEOGCS_GDA94_FRAG = (
    'GEOGCS["GDA94",DATUM["Geocentric_Datum_of_Australia_1994",'
    'SPHEROID["GRS 1980",6378137,298.257222101,'
    'AUTHORITY["EPSG","7019"]],AUTHORITY["EPSG","6283"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4283"]]')

# equal-area grids: epsg -> (PROJCS name, GEOGCS fragment)
_GRID_NAME_GEOGCS = {
    5070: ('NAD83 / Conus Albers',
           _GEOGCS_GRS80.format(
               datum_name='NAD83',
               datum_wkt='North_American_Datum_1983', datum_auth=6269)
           + ',AUTHORITY["EPSG","4269"]]'),
    3577: ('GDA94 / Australian Albers', _GEOGCS_GDA94_FRAG),
    3035: ('ETRS89-extended / LAEA Europe',
           _GEOGCS_GRS80.format(
               datum_name='ETRS89',
               datum_wkt='European_Terrestrial_Reference_System_1989',
               datum_auth=6258)
           + ',AUTHORITY["EPSG","4258"]]'),
    6931: ('WGS 84 / NSIDC EASE-Grid 2.0 North', _GEOGCS_WGS84_FRAG),
    6932: ('WGS 84 / NSIDC EASE-Grid 2.0 South', _GEOGCS_WGS84_FRAG),
    3978: ('NAD83 / Canada Atlas Lambert',
           _GEOGCS_GRS80.format(
               datum_name='NAD83',
               datum_wkt='North_American_Datum_1983', datum_auth=6269)
           + ',AUTHORITY["EPSG","4269"]]'),
    2154: ('RGF93 v1 / Lambert-93',
           _GEOGCS_GRS80.format(
               datum_name='RGF93 v1',
               datum_wkt='Reseau_Geodesique_Francais_1993_v1',
               datum_auth=6171)
           + ',AUTHORITY["EPSG","4171"]]'),
}

_WKT_LCC_TEMPLATE = (
    'PROJCS["{name}",{geogcs},'
    'PROJECTION["Lambert_Conformal_Conic_2SP"],'
    'PARAMETER["latitude_of_origin",{lat0}],'
    'PARAMETER["central_meridian",{lon0}],'
    'PARAMETER["standard_parallel_1",{sp1}],'
    'PARAMETER["standard_parallel_2",{sp2}],'
    'PARAMETER["false_easting",{fe}],'
    'PARAMETER["false_northing",{fn}],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
    'AUTHORITY["EPSG","{epsg}"]]')

_WKT_ALBERS_TEMPLATE = (
    'PROJCS["{name}",{geogcs},'
    'PROJECTION["Albers_Conic_Equal_Area"],'
    'PARAMETER["latitude_of_center",{lat0}],'
    'PARAMETER["longitude_of_center",{lon0}],'
    'PARAMETER["standard_parallel_1",{sp1}],'
    'PARAMETER["standard_parallel_2",{sp2}],'
    'PARAMETER["false_easting",{fe}],'
    'PARAMETER["false_northing",{fn}],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
    'AUTHORITY["EPSG","{epsg}"]]')

_WKT_LAEA_TEMPLATE = (
    'PROJCS["{name}",{geogcs},'
    'PROJECTION["Lambert_Azimuthal_Equal_Area"],'
    'PARAMETER["latitude_of_center",{lat0}],'
    'PARAMETER["longitude_of_center",{lon0}],'
    'PARAMETER["false_easting",{fe}],'
    'PARAMETER["false_northing",{fn}],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
    'AUTHORITY["EPSG","{epsg}"]]')

_WKT_CEA_TEMPLATE = (
    'PROJCS["{name}",{geogcs},'
    'PROJECTION["Cylindrical_Equal_Area"],'
    'PARAMETER["standard_parallel_1",{lat_ts}],'
    'PARAMETER["central_meridian",{lon0}],'
    'PARAMETER["false_easting",{fe}],'
    'PARAMETER["false_northing",{fn}],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
    'AUTHORITY["EPSG","{epsg}"]]')

_WKT_MERC_TEMPLATE = (
    'PROJCS["{name}",{geogcs},'
    'PROJECTION["Mercator_1SP"],'
    'PARAMETER["central_meridian",{lon0}],'
    'PARAMETER["scale_factor",{k0}],'
    'PARAMETER["false_easting",{fe}],'
    'PARAMETER["false_northing",{fn}],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AXIS["Easting",EAST],AXIS["Northing",NORTH],'
    'AUTHORITY["EPSG","{epsg}"]]')

_WKT_UPS_TEMPLATE = (
    'PROJCS["WGS 84 / UPS {ns} (E,N)",GEOGCS["WGS 84",'
    'DATUM["WGS_1984",SPHEROID["WGS 84",6378137,298.257223563,'
    'AUTHORITY["EPSG","7030"]],AUTHORITY["EPSG","6326"]],'
    'PRIMEM["Greenwich",0,AUTHORITY["EPSG","8901"]],'
    'UNIT["degree",0.0174532925199433,AUTHORITY["EPSG","9122"]],'
    'AUTHORITY["EPSG","4326"]],PROJECTION["Polar_Stereographic"],'
    'PARAMETER["latitude_of_origin",{lat0}],'
    'PARAMETER["central_meridian",0],'
    'PARAMETER["scale_factor",{k0}],'
    'PARAMETER["false_easting",{fe}],'
    'PARAMETER["false_northing",{fn}],'
    'UNIT["metre",1,AUTHORITY["EPSG","9001"]],'
    'AUTHORITY["EPSG","{epsg}"]]')


def _towgs84_wkt(towgs84):
    """',TOWGS84[...]' fragment (empty for the null transformation)."""
    if _effective_shift(towgs84) is None and towgs84 is None:
        return ''
    body = ','.join(f'{float(v)!r}' for v in towgs84)
    return f',TOWGS84[{body}]'


def _custom_geogcs_wkt(ell, towgs84=None):
    tw = _towgs84_wkt(towgs84)
    if not isinstance(ell, str):    # sphere radius (sinusoidal/MODIS)
        return ('GEOGCS["unknown",DATUM["unknown",'
                f'SPHEROID["unknown",{float(ell)!r},0]{tw}],'
                'PRIMEM["Greenwich",0],'
                'UNIT["degree",0.0174532925199433]]')
    a, invf = _ELLIPSOIDS[ell]
    return ('GEOGCS["unknown",DATUM["unknown",'
            f'SPHEROID["unknown",{a:.10g},{invf:.12g}]{tw}],'
            'PRIMEM["Greenwich",0],'
            'UNIT["degree",0.0174532925199433]]')


def _unit_wkt(unit):
    name, lit = _UNIT_WKT_NAME.get(unit, ('unnamed', f'{unit:.17g}'))
    return f'UNIT["{name}",{lit}]'


def _custom_to_wkt(custom, unit=1.0, towgs84=None):
    fam = custom[0]
    if fam == 'geog':
        return _custom_geogcs_wkt(custom[1], towgs84)
    if fam == 'ps':
        lat_ts, lon0, fe, fn, north, k0, ell = custom[1:]
        params = [('latitude_of_origin',
                   lat_ts if lat_ts is not None
                   else (90.0 if north else -90.0)),
                  ('central_meridian', lon0)]
        if k0 is not None:
            params.append(('scale_factor', k0))
        params += [('false_easting', fe), ('false_northing', fn)]
        proj = 'Polar_Stereographic'
    else:
        ell = custom[1]
        if fam == 'tm':
            lat0, lon0, k0, fe, fn = custom[2:]
            proj = 'Transverse_Mercator'
            params = [('latitude_of_origin', lat0),
                      ('central_meridian', lon0),
                      ('scale_factor', k0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'aea':
            lat0, lon0, sp1, sp2, fe, fn = custom[2:]
            proj = 'Albers_Conic_Equal_Area'
            params = [('latitude_of_center', lat0),
                      ('longitude_of_center', lon0),
                      ('standard_parallel_1', sp1),
                      ('standard_parallel_2', sp2),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'laea':
            lat0, lon0, fe, fn = custom[2:]
            proj = 'Lambert_Azimuthal_Equal_Area'
            params = [('latitude_of_center', lat0),
                      ('longitude_of_center', lon0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'sinu':
            lon0, fe, fn = custom[2:]
            proj = 'Sinusoidal'
            params = [('longitude_of_center', lon0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'cea':
            lat_ts, lon0, fe, fn = custom[2:]
            proj = 'Cylindrical_Equal_Area'
            params = [('standard_parallel_1', lat_ts),
                      ('central_meridian', lon0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'merc':
            lon0, k0, fe, fn = custom[2:]
            proj = 'Mercator_1SP'
            params = [('central_meridian', lon0),
                      ('scale_factor', k0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'omerc':
            latc, lonc, alpha, gamma, k0, fe, fn, vb = custom[2:]
            proj = ('Hotine_Oblique_Mercator_Azimuth_Center' if vb
                    else 'Hotine_Oblique_Mercator')
            params = [('latitude_of_center', latc),
                      ('longitude_of_center', lonc),
                      ('azimuth', alpha),
                      ('rectified_grid_angle', gamma),
                      ('scale_factor', k0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'somerc':
            lat0, lon0, k0, fe, fn = custom[2:]
            # GDAL encodes the Swiss oblique Mercator as Hotine
            # azimuth-center with azimuth = rectified grid angle = 90
            proj = 'Hotine_Oblique_Mercator_Azimuth_Center'
            params = [('latitude_of_center', lat0),
                      ('longitude_of_center', lon0),
                      ('azimuth', 90.0),
                      ('rectified_grid_angle', 90.0),
                      ('scale_factor', k0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'krovak':
            latc, lonc, alphac, latp, k0, fe, fn = custom[2:]
            proj = 'Krovak'
            params = [('latitude_of_center', latc),
                      ('longitude_of_center', lonc),
                      ('azimuth', alphac),
                      ('pseudo_standard_parallel_1', latp),
                      ('scale_factor', k0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'sterea':
            lat0, lon0, k0, fe, fn = custom[2:]
            proj = 'Oblique_Stereographic'
            params = [('latitude_of_origin', lat0),
                      ('central_meridian', lon0),
                      ('scale_factor', k0),
                      ('false_easting', fe), ('false_northing', fn)]
        elif fam == 'eqc':
            lat_ts, lat0, lon0, fe, fn = custom[2:]
            proj = 'Equirectangular'
            params = [('standard_parallel_1', lat_ts),
                      ('latitude_of_origin', lat0),
                      ('central_meridian', lon0),
                      ('false_easting', fe), ('false_northing', fn)]
        else:   # lcc
            lat0, lon0, sp1, sp2, fe, fn = custom[2:8]
            k0 = custom[8] if len(custom) > 8 else 1.0
            proj = 'Lambert_Conformal_Conic_2SP'
            params = [('latitude_of_origin', lat0),
                      ('central_meridian', lon0),
                      ('standard_parallel_1', sp1),
                      ('standard_parallel_2', sp2),
                      ('false_easting', fe), ('false_northing', fn)]
            if k0 != 1.0:
                params.insert(2, ('scale_factor', k0))
    # repr = shortest exact round-trip float text (PARAMETER values are
    # in the PROJCS's UNIT, e.g. feet for State Plane grids)
    body = ','.join(f'PARAMETER["{k}",{float(v)!r}]' for k, v in params)
    return (f'PROJCS["unnamed",{_custom_geogcs_wkt(ell, towgs84)},'
            f'PROJECTION["{proj}"],{body},{_unit_wkt(unit)}]')


def _unit_proj4(unit):
    if unit == 1.0:
        return '+units=m'
    if unit == _FOOT:
        return '+units=ft'
    if unit == _US_FOOT:
        return '+units=us-ft'
    return f'+to_meter={unit:.17g}'


def _custom_to_proj4(custom, unit=1.0, towgs84=None):
    p4 = _custom_to_proj4_base(custom, unit)
    if _effective_shift(towgs84) is not None or towgs84 is not None:
        tw = ','.join(f'{float(v):g}' for v in towgs84)
        p4 = p4.replace(' +no_defs', f' +towgs84={tw} +no_defs')
    return p4


def _custom_to_proj4_base(custom, unit=1.0):
    fam = custom[0]
    if unit != 1.0:
        # proj4 +x_0/+y_0 are always metres (PROJ's fr_meter applies
        # to proj+x_0); the tuple keeps them in native units
        c = list(custom)
        for i in _FEFN_IDX[fam]:
            c[i] = c[i] * unit
        custom = tuple(c)

    def ell_frag(ell):
        a, invf = _ELLIPSOIDS[ell]
        if ell in ('WGS84', 'GRS80'):
            return f'+ellps={ell}'
        name = _ELLPS_PROJ4_NAME.get(ell)
        if name:
            return f'+ellps={name}'
        return f'+a={a:.10g} +rf={invf:.12g}'

    un = _unit_proj4(unit)
    if fam == 'geog':
        return f'+proj=longlat {ell_frag(custom[1])} +no_defs'
    if fam == 'sinu':
        ell, lon0, fe, fn = custom[1:]
        ef = (f'+R={float(ell)!r}' if not isinstance(ell, str)
              else ell_frag(ell))
        return (f'+proj=sinu +lon_0={lon0!r} +x_0={fe!r} '
                f'+y_0={fn!r} {ef} {un} +no_defs')
    if fam == 'cea':
        ell, lat_ts, lon0, fe, fn = custom[1:]
        return (f'+proj=cea +lat_ts={lat_ts!r} +lon_0={lon0!r} '
                f'+x_0={fe!r} +y_0={fn!r} {ell_frag(ell)} {un} '
                '+no_defs')
    if fam == 'ps':
        lat_ts, lon0, fe, fn, north, k0, ell = custom[1:]
        lat0 = 90 if north else -90
        mid = (f'+k={k0!r}' if lat_ts is None
               else f'+lat_ts={lat_ts!r}')
        return (f'+proj=stere +lat_0={lat0} {mid} +lon_0={lon0!r} '
                f'+x_0={fe!r} +y_0={fn!r} {ell_frag(ell)} {un} '
                '+no_defs')
    ell = custom[1]
    if fam == 'tm':
        lat0, lon0, k0, fe, fn = custom[2:]
        return (f'+proj=tmerc +lat_0={lat0!r} +lon_0={lon0!r} '
                f'+k={k0!r} +x_0={fe!r} +y_0={fn!r} '
                f'{ell_frag(ell)} {un} +no_defs')
    if fam == 'aea':
        lat0, lon0, sp1, sp2, fe, fn = custom[2:]
        return (f'+proj=aea +lat_0={lat0!r} +lon_0={lon0!r} '
                f'+lat_1={sp1!r} +lat_2={sp2!r} +x_0={fe!r} '
                f'+y_0={fn!r} {ell_frag(ell)} {un} +no_defs')
    if fam == 'laea':
        lat0, lon0, fe, fn = custom[2:]
        return (f'+proj=laea +lat_0={lat0!r} +lon_0={lon0!r} '
                f'+x_0={fe!r} +y_0={fn!r} {ell_frag(ell)} {un} '
                '+no_defs')
    if fam == 'merc':
        lon0, k0, fe, fn = custom[2:]
        return (f'+proj=merc +lon_0={lon0!r} +k={k0!r} '
                f'+x_0={fe!r} +y_0={fn!r} {ell_frag(ell)} {un} '
                '+no_defs')
    if fam == 'omerc':
        latc, lonc, alpha, gamma, k0, fe, fn, vb = custom[2:]
        nu = '' if vb else '+no_uoff '   # PROJ: variant A flag
        return (f'+proj=omerc +lat_0={latc!r} +lonc={lonc!r} '
                f'+alpha={alpha!r} +gamma={gamma!r} +k_0={k0!r} '
                f'{nu}+x_0={fe!r} +y_0={fn!r} {ell_frag(ell)} {un} '
                '+no_defs')
    if fam == 'somerc':
        lat0, lon0, k0, fe, fn = custom[2:]
        return (f'+proj=somerc +lat_0={lat0!r} +lon_0={lon0!r} '
                f'+k_0={k0!r} +x_0={fe!r} +y_0={fn!r} '
                f'{ell_frag(ell)} {un} +no_defs')
    if fam == 'krovak':
        latc, lonc, alphac, latp, k0, fe, fn = custom[2:]
        # PROJ's krovak hardcodes the 78.5-deg pseudo standard
        # parallel; +alpha carries the cone azimuth
        return (f'+proj=krovak +lat_0={latc!r} +lon_0={lonc!r} '
                f'+alpha={alphac!r} +k={k0!r} +x_0={fe!r} '
                f'+y_0={fn!r} {ell_frag(ell)} {un} +no_defs')
    if fam == 'sterea':
        lat0, lon0, k0, fe, fn = custom[2:]
        return (f'+proj=sterea +lat_0={lat0!r} +lon_0={lon0!r} '
                f'+k={k0!r} +x_0={fe!r} +y_0={fn!r} '
                f'{ell_frag(ell)} {un} +no_defs')
    if fam == 'eqc':
        lat_ts, lat0, lon0, fe, fn = custom[2:]
        return (f'+proj=eqc +lat_ts={lat_ts!r} +lat_0={lat0!r} '
                f'+lon_0={lon0!r} +x_0={fe!r} +y_0={fn!r} '
                f'{ell_frag(ell)} {un} +no_defs')
    lat0, lon0, sp1, sp2, fe, fn = custom[2:8]
    k0 = custom[8] if len(custom) > 8 else 1.0
    kf = f' +k_0={k0!r}' if k0 != 1.0 else ''
    return (f'+proj=lcc +lat_0={lat0!r} +lon_0={lon0!r} '
            f'+lat_1={sp1!r} +lat_2={sp2!r}{kf} +x_0={fe!r} '
            f'+y_0={fn!r} {ell_frag(ell)} {un} +no_defs')


# user-defined projection families: family -> (forward fn, inverse fn).
# A custom CRS carries ``custom = (family, *args)`` where ``*args`` are
# exactly the function's parameters after (lat/x, lon/y):
#   ('tm',  ell, lat0, lon0, k0, fe, fn)
#   ('aea', ell, lat0, lon0, sp1, sp2, fe, fn)
#   ('laea', ell, lat0, lon0, fe, fn)
#   ('lcc', ell, lat0, lon0, sp1, sp2, fe, fn[, k0])
#   ('ps',  lat_ts|None, lon0, fe, fn, north, k0|None, ell)
#   ('merc', ell, lon0, k0, fe, fn)
#   ('sinu', ell|sphere_radius, lon0, fe, fn)    (MODIS grid)
#   ('cea', ell, lat_ts, lon0, fe, fn)           (EASE-Grid 2.0 style)
#   ('geog', ell)                                (geographic lat/lon on
#                                                 a classical ellipsoid;
#                                                 datum via towgs84)
#   ('omerc', ell, latc, lonc, alpha, gamma, k0, fe, fn, variant_b)
#   ('somerc', ell, lat0, lon0, k0, fe, fn)      (Swiss CH1903 grids)
#   ('krovak', ell, latc, lonc, alphac, latp, k0, fe, fn)  (S-JTSK,
#                                                 east-north axes)
#   ('sterea', ell, lat0, lon0, k0, fe, fn)      (Dutch RD New)
#   ('eqc', ell, lat_ts, lat0, lon0, fe, fn)     (world equidistant
#                                                 cylindrical)
_CUSTOM_FAMILIES = {
    'tm': None, 'aea': None, 'laea': None, 'lcc': None, 'ps': None,
    'merc': None, 'sinu': None, 'cea': None, 'geog': None,
    'omerc': None, 'somerc': None, 'krovak': None, 'sterea': None,
    'eqc': None,
}


_PROJ4_ELLPS = {
    'GRS80': 'GRS80', 'WGS84': 'WGS84',
    'airy': (6377563.396, 299.3249646),
    'clrk66': (6378206.4, 294.9786982139006),
    'intl': (6378388.0, 297.0),
    'krass': (6378245.0, 298.3),
    'bessel': (6377397.155, 299.1528128),
    'evrstSS': (6377298.556, 300.8017),   # Everest 1830 (1967 Def.)
}
# registry ellipsoid -> canonical +ellps name (values match
# _PROJ4_ELLPS so the pair round-trips through _ensure_ellipsoid)
_ELLPS_PROJ4_NAME = {'AIRY1830': 'airy', 'BESSEL1841': 'bessel',
                     'CLARKE1866': 'clrk66', 'INTL1924': 'intl',
                     'KRASS1940': 'krass', 'EVEREST1967': 'evrstSS'}


def _proj4_ellipsoid(proj4):
    """Ellipsoid registry name for a proj4 string (datum/ellps/a+rf/
    a+b). Spheres (+a == +b, e.g. EASE-Grid v1 / authalic grids) raise
    — the engine is ellipsoidal-only."""
    if '+datum=NAD83' in proj4 or '+datum=ETRS89' in proj4 \
            or '+ellps=GRS80' in proj4:
        return 'GRS80'
    if '+datum=WGS84' in proj4 or '+ellps=WGS84' in proj4:
        return 'WGS84'
    ma = re.search(rf'\+a={_NUM_RE}', proj4)
    mr = re.search(rf'\+rf={_NUM_RE}', proj4)
    mb = re.search(rf'\+b={_NUM_RE}', proj4)
    if ma and mr:
        return _ensure_ellipsoid(float(ma.group(1)),
                                 float(mr.group(1)))
    if ma and mb:
        a, b = float(ma.group(1)), float(mb.group(1))
        if a == b:
            raise ValueError(
                f'spherical ellipsoid (+a == +b) not supported: {proj4}')
        return _ensure_ellipsoid(a, a / (a - b))
    if ma and not mb and not mr:
        raise ValueError(
            f'+a without +b/+rf (sphere?) not supported: {proj4}')
    m = re.search(r'\+ellps=(\w+)', proj4)
    if m:
        v = _PROJ4_ELLPS.get(m.group(1))
        if v is None:
            raise ValueError(
                f'unknown proj4 ellipsoid +ellps={m.group(1)}')
        return v if isinstance(v, str) else _ensure_ellipsoid(*v)
    return 'WGS84'


def _custom_forward(lat, lon, custom):
    fam = custom[0]
    if fam == 'geog':   # geographic: (x, y) = (lon, lat) degrees
        return (np.asarray(lon, dtype=np.float64),
                np.asarray(lat, dtype=np.float64))
    fwd = {'tm': tm_forward_general, 'aea': albers_forward,
           'laea': laea_forward, 'lcc': lcc_forward,
           'ps': polar_stereo_forward, 'merc': mercator_forward,
           'sinu': sinusoidal_forward, 'cea': cea_forward,
           'omerc': omerc_forward, 'somerc': somerc_forward,
           'krovak': krovak_forward, 'sterea': sterea_forward,
           'eqc': eqc_forward}[fam]
    return fwd(lat, lon, *custom[1:])


def _custom_inverse(x, y, custom):
    fam = custom[0]
    if fam == 'geog':
        return (np.asarray(y, dtype=np.float64),
                np.asarray(x, dtype=np.float64))
    inv = {'tm': tm_inverse_general, 'aea': albers_inverse,
           'laea': laea_inverse, 'lcc': lcc_inverse,
           'ps': polar_stereo_inverse, 'merc': mercator_inverse,
           'sinu': sinusoidal_inverse, 'cea': cea_inverse,
           'omerc': omerc_inverse, 'somerc': somerc_inverse,
           'krovak': krovak_inverse, 'sterea': sterea_inverse,
           'eqc': eqc_inverse}[fam]
    return inv(x, y, *custom[1:])


# index of (false_easting, false_northing) inside each family's custom
# tuple — the only parameters expressed in the CRS's linear unit
_FEFN_IDX = {'tm': (5, 6), 'aea': (6, 7), 'laea': (4, 5),
             'lcc': (6, 7), 'ps': (3, 4), 'merc': (4, 5),
             'sinu': (3, 4), 'cea': (4, 5), 'geog': (),
             'omerc': (7, 8), 'somerc': (5, 6), 'krovak': (7, 8),
             'sterea': (5, 6), 'eqc': (5, 6)}
