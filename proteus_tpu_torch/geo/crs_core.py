"""Shared geodesy core: ellipsoids, datum transformations, and the
auxiliary-latitude helpers every projection family builds on.

Split out of crs.py (round 5); see crs.py for the engine overview and
the reference-parity contract (dswx_hls.py:3385-3461, core.py:93-155).
"""

import numpy as np
from functools import lru_cache

# ellipsoids: name -> (semi-major axis a, inverse flattening 1/f)
_ELLIPSOIDS = {
    'WGS84': (6378137.0, 298.257223563),
    'GRS80': (6378137.0, 298.257222101),  # NAD83 / ETRS89
    # classical datum ellipsoids (EPSG ellipsoid codes in comments)
    'AIRY1830': (6377563.396, 299.3249646),        # 7001 (OSGB36)
    'BESSEL1841': (6377397.155, 299.1528128),      # 7004 (CH1903, Tokyo)
    'CLARKE1866': (6378206.4, 294.9786982139006),  # 7008 (NAD27)
    'INTL1924': (6378388.0, 297.0),                # 7022 (ED50)
    'KRASS1940': (6378245.0, 298.3),               # 7024 (Pulkovo 1942)
    'EVEREST1967': (6377298.556, 300.8017),        # 7016 (Timbalai 1948)
}

# WGS84 ellipsoid (module-level: the polar-stereo code and external
# users are WGS84-only)
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2.0 - _F)
_E = np.sqrt(_E2)
_K0 = 0.9996
_FALSE_EASTING = 500000.0


@lru_cache(maxsize=None)
def _ell_consts(ell):
    """(a, e2, e) for a named ellipsoid."""
    a, invf = _ELLIPSOIDS[ell]
    f = 1.0 / invf
    e2 = f * (2.0 - f)
    return a, e2, np.sqrt(e2)


def _ensure_ellipsoid(a, invf):
    """Registry name for ellipsoid (a, 1/f); registers an ad-hoc entry
    for non-standard ellipsoids found in user-defined CRS (e.g. Airy
    1830, Clarke 1866, International 1924). Spheres (1/f = 0, the
    authalic-sphere EASE-Grid v1 / legacy grids) and nonsensical
    parameters are rejected up front so they fail at parse/coverage
    time, not with a division inside the warp."""
    a, invf = float(a), float(invf)
    if not (1e6 < a < 1e8) or not np.isfinite(invf) or invf <= 0 \
            or invf < 100:
        raise ValueError(
            f'unsupported ellipsoid (a={a:g}, 1/f={invf:g}): spherical '
            'and non-Earth ellipsoids are not supported')
    for name, (ra, rf) in _ELLIPSOIDS.items():
        if abs(ra - a) < 1e-3 and abs(rf - invf) < 1e-8:
            return name
    name = f'E_{a:.4f}_{invf:.9f}'
    _ELLIPSOIDS[name] = (a, invf)
    return name


# --------------------------------------------------------------------------
# Datum transformations (TOWGS84 / Helmert).
#
# The reference resolves ANY OSR SRS (dswx_hls.py:3385-3461); for CRS on
# classical datums OSR applies the parametric Helmert transformation the
# SRS carries (the WKT TOWGS84[] clause / proj4 +towgs84=). We implement
# the same chain: geodetic (h=0) -> geocentric cartesian -> 7-parameter
# position-vector transformation (EPSG method 9606; the 3-parameter
# geocentric translation 9603 is its rx=ry=rz=ds=0 case, which is also
# the TOWGS84 convention) -> geodetic on the target ellipsoid. 2D
# transforms take h=0 on the source datum and discard the output height,
# exactly as OSR does for 2D points. Grid-based transformations (NTv2,
# OSTN15, NADCON) need grid files neither we nor a grid-less OSR have —
# the parametric path below is what GDAL applies without them.
# Verified against the EPSG Guidance Note 7-2 worked examples
# (geographic/geocentric conversion and the WGS72->WGS84 position-vector
# example) in tests/test_crs_datum.py.

def geodetic_to_geocentric(lat_deg, lon_deg, ell, h=0.0):
    """Geodetic (degrees, ellipsoidal height m) -> geocentric X,Y,Z (m).

    EPSG Guidance Note 7-2 §2.2 (method 9602 one-way)."""
    a, e2, _e = _ell_consts(ell) if isinstance(ell, str) else (
        float(ell), 0.0, 0.0)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    sin_lat = np.sin(lat)
    nu = a / np.sqrt(1.0 - e2 * sin_lat * sin_lat)
    cos_lat = np.cos(lat)
    x = (nu + h) * cos_lat * np.cos(lon)
    y = (nu + h) * cos_lat * np.sin(lon)
    z = (nu * (1.0 - e2) + h) * sin_lat
    return x, y, z


def geocentric_to_geodetic(x, y, z, ell):
    """Geocentric X,Y,Z (m) -> geodetic (lat, lon degrees; height
    discarded — 2D transform semantics)."""
    a, e2, _e = _ell_consts(ell) if isinstance(ell, str) else (
        float(ell), 0.0, 0.0)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    p = np.hypot(x, y)
    # fixed-point iteration on the standard closed form; converges to
    # float64 roundoff in < 6 iterations for |h| << a (h here is the
    # small height the Helmert shift introduces on the target datum)
    lat = np.arctan2(z, p * (1.0 - e2))
    for _ in range(8):
        sin_lat = np.sin(lat)
        nu = a / np.sqrt(1.0 - e2 * sin_lat * sin_lat)
        h = np.where(np.abs(np.cos(lat)) > 1e-10,
                     p / np.cos(lat) - nu,
                     np.abs(z) / np.maximum(np.abs(sin_lat), 1e-300)
                     - nu * (1.0 - e2))
        lat = np.arctan2(z, p * (1.0 - e2 * nu / (nu + h)))
    return np.degrees(lat), np.degrees(np.arctan2(y, x))


def _towgs84_matrix(p7):
    """(t vector, M matrix) of the position-vector transformation."""
    tx, ty, tz, rx, ry, rz, ds = [float(v) for v in p7]
    s = 1.0 + ds * 1e-6
    arc = np.pi / (180.0 * 3600.0)      # arc-seconds -> radians
    rx, ry, rz = rx * arc, ry * arc, rz * arc
    m = s * np.array([[1.0, -rz, ry],
                      [rz, 1.0, -rx],
                      [-ry, rx, 1.0]], dtype=np.float64)
    return np.array([tx, ty, tz], dtype=np.float64), m


def helmert_position_vector(x, y, z, p7, inverse=False):
    """7-parameter position-vector Helmert transformation (EPSG 9606,
    the TOWGS84 convention: rotations in arc-seconds, scale in ppm).
    ``inverse=True`` applies the exact inverse (solves the forward
    relation rather than negating the parameters)."""
    t, m = _towgs84_matrix(p7)
    v = np.stack([np.asarray(x, dtype=np.float64).ravel(),
                  np.asarray(y, dtype=np.float64).ravel(),
                  np.asarray(z, dtype=np.float64).ravel()])
    if inverse:
        out = np.linalg.solve(m, v - t[:, None])
    else:
        out = m @ v + t[:, None]
    shape = np.shape(x)
    return (out[0].reshape(shape), out[1].reshape(shape),
            out[2].reshape(shape))


def _effective_shift(p7):
    """None for the null transformation (absent or all-zero TOWGS84)."""
    if p7 is None or all(float(v) == 0.0 for v in p7):
        return None
    return tuple(float(v) for v in p7)


def shift_datum(lat, lon, src_ell, src_p7, dst_ell, dst_p7):
    """Geodetic datum shift src -> WGS84 -> dst via geocentric Helmert
    (h=0 on the source datum; output height discarded)."""
    src_p7 = _effective_shift(src_p7)
    dst_p7 = _effective_shift(dst_p7)
    if src_p7 == dst_p7:
        return (np.asarray(lat, dtype=np.float64),
                np.asarray(lon, dtype=np.float64))
    x, y, z = geodetic_to_geocentric(lat, lon, src_ell)
    if src_p7 is not None:
        x, y, z = helmert_position_vector(x, y, z, src_p7)
    if dst_p7 is not None:
        x, y, z = helmert_position_vector(x, y, z, dst_p7, inverse=True)
    return geocentric_to_geodetic(x, y, z, dst_ell)


def _norm_towgs84(vals):
    """Normalize a parsed TOWGS84 parameter list: pad 3-parameter form
    with zero rotations/scale; all-zero (the explicit null
    transformation) stays as a 7-tuple of zeros so it can OVERRIDE a
    registry default."""
    vals = [float(v) for v in vals]
    if len(vals) == 3:
        vals += [0.0, 0.0, 0.0, 0.0]
    if len(vals) != 7:
        raise ValueError(
            f'TOWGS84 needs 3 or 7 parameters, got {len(vals)}')
    return tuple(vals)


# registry datum shifts to WGS84 (TOWGS84 convention), applied to CRS
# whose datum is not WGS84-equivalent. EPSG transformation cited per
# entry; an explicit TOWGS84[]/+towgs84= in the file overrides these.
_SHIFT_OSGB36 = (446.448, -125.157, 542.06, 0.15, 0.247, 0.842,
                 -20.489)                    # EPSG 1314 (Petroleum, 2m)
_SHIFT_ED50 = (-87.0, -98.0, -121.0, 0.0, 0.0, 0.0, 0.0)   # EPSG 1133
_SHIFT_NAD27 = (-8.0, 160.0, 176.0, 0.0, 0.0, 0.0, 0.0)    # EPSG 1173
_SHIFT_TOKYO = (-146.414, 507.337, 680.507, 0.0, 0.0, 0.0,
                0.0)                         # Japan GSI / GDAL default
_SHIFT_PULKOVO42 = (28.0, -130.0, -95.0, 0.0, 0.0, 0.0, 0.0)  # EPSG 1254
_SHIFT_CH1903 = (674.4, 15.1, 405.3, 0.0, 0.0, 0.0, 0.0)    # EPSG 1753
_SHIFT_CH1903P = (674.374, 15.056, 405.346, 0.0, 0.0, 0.0,
                  0.0)                       # EPSG 1676 (CH1903+)
_SHIFT_TIMBALAI = (-679.0, 669.0, -48.0, 0.0, 0.0, 0.0, 0.0)  # EPSG 1236
_SHIFT_SJTSK = (589.0, 76.0, 480.0, 0.0, 0.0, 0.0, 0.0)      # EPSG 1623
_SHIFT_AMERSFOORT = (565.417, 50.3319, 465.552, -0.398957,
                     0.343988, -1.8774, 4.0725)
# ^ the legacy proj4/GDAL epsg-init +towgs84 set every install carried
# for 28992 (matches it to ~2 m; EPSG's own 15934 publishes slightly
# different parameters: 565.2369, 50.0087, 465.658, ...)



def _q_authalic(lat, e, e2):
    """Snyder (3-12): q(phi), so that q/qp = sin(authalic latitude)."""
    s = np.sin(lat)
    return (1.0 - e2) * (s / (1.0 - e2 * s * s)
                         - np.log((1.0 - e * s) / (1.0 + e * s))
                         / (2.0 * e))


def _phi_from_q(q, e, e2, qp):
    """Latitude from authalic q: series seed (Snyder 3-18) + Newton
    polish to full float64 (dq/dphi = 2(1-e2)cos phi/(1-e2 sin^2)^2)."""
    beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
    e4, e6 = e2 * e2, e2 * e2 * e2
    lat = (beta
           + (e2 / 3 + 31 * e4 / 180 + 517 * e6 / 5040) * np.sin(2 * beta)
           + (23 * e4 / 360 + 251 * e6 / 3780) * np.sin(4 * beta)
           + (761 * e6 / 45360) * np.sin(6 * beta))
    for _ in range(3):
        s = np.sin(lat)
        f = _q_authalic(lat, e, e2) - q
        df = 2.0 * (1.0 - e2) * np.cos(lat) / (1.0 - e2 * s * s) ** 2
        step = f / np.maximum(df, 1e-12)
        lat = np.clip(lat - np.clip(step, -0.1, 0.1),
                      -np.pi / 2, np.pi / 2)
    return lat


def _wrap_pi(x):
    return (x + np.pi) % (2.0 * np.pi) - np.pi



def _lcc_t(lat, e):
    """Snyder (15-9): t(phi) for the conformal conic."""
    s = np.sin(lat)
    return (np.tan(np.pi / 4 - lat / 2)
            / ((1.0 - e * s) / (1.0 + e * s)) ** (e / 2))



def _sinu_ell(ell_or_radius):
    """(a, e2, e) accepting a registry ellipsoid name OR a sphere
    radius (float). The MODIS sinusoidal grid lives on the authalic
    sphere R = 6371007.181 — the one production-relevant spherical
    'datum', carried as a radius so the ellipsoidal-only registry can
    keep rejecting spheres everywhere else."""
    if isinstance(ell_or_radius, str):
        return _ell_consts(ell_or_radius)
    r = float(ell_or_radius)
    if not (1e6 < r < 1e8):
        raise ValueError(f'bad sphere radius: {r!r}')
    return r, 0.0, 0.0


def _merid_arc(lat, a, e2):
    """Meridian arc length M(phi) (Snyder 3-21); reduces to a*phi on
    the sphere (e2 = 0)."""
    e4, e6 = e2 * e2, e2 * e2 * e2
    return a * ((1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * lat
                - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024)
                * np.sin(2 * lat)
                + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * lat)
                - (35 * e6 / 3072) * np.sin(6 * lat))


def _lat_from_merid(M, a, e2):
    """phi from meridian arc via the rectifying latitude (Snyder
    3-26), Newton-polished to full float64."""
    e4, e6 = e2 * e2, e2 * e2 * e2
    mu = M / (a * (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256))
    se = np.sqrt(1.0 - e2)
    e1 = (1.0 - se) / (1.0 + se)
    lat = (mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * np.sin(2 * mu)
           + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * np.sin(4 * mu)
           + (151 * e1 ** 3 / 96) * np.sin(6 * mu)
           + (1097 * e1 ** 4 / 512) * np.sin(8 * mu))
    for _ in range(2):      # dM/dphi = a(1-e2)/(1-e2 sin^2)^(3/2)
        s = np.sin(lat)
        df = a * (1.0 - e2) / (1.0 - e2 * s * s) ** 1.5
        lat = lat - (_merid_arc(lat, a, e2) - M) / df
    return lat


def _isometric_lat(lat, e):
    """Isometric latitude psi(phi) (radians in, unitless out)."""
    esp = e * np.sin(lat)
    return (np.log(np.tan(np.pi / 4.0 + lat / 2.0))
            - (e / 2.0) * np.log((1.0 + esp) / (1.0 - esp)))


def _lat_from_isometric(psi, e):
    """Invert the isometric latitude by Newton iteration."""
    lat = 2.0 * np.arctan(np.exp(psi)) - np.pi / 2.0
    e2 = e * e
    for _ in range(8):
        sin_lat = np.sin(lat)
        f = _isometric_lat(lat, e) - psi
        dpsi = (1.0 - e2) / ((1.0 - e2 * sin_lat * sin_lat)
                             * np.cos(lat))
        lat = lat - f / dpsi
    return lat

