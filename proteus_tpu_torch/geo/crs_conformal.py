"""Conformal projection families: polar stereographic (variants A/B),
Lambert Conformal Conic (1SP/2SP), Mercator (A/B) + web Mercator,
Hotine Oblique Mercator (A/B), Swiss Oblique Mercator, Krovak, and
Oblique (double) Stereographic.

Split out of crs.py (round 5); formulas per Snyder 1987 and EPSG
Guidance Note 7-2, verified against the worked examples in
tests/test_geo.py / test_crs_omerc.py / test_crs_sterea.py.
"""

import numpy as np

from .crs_core import (_A, _E, _ell_consts, _isometric_lat,
                       _lat_from_isometric, _lcc_t, _wrap_pi)

# ---------------------------------------------------------------------------
# Polar Stereographic (variant B) on WGS84 — the one plausible real-world
# DEM/ancillary CRS outside 4326/UTM (reference accepts any OSR SRS at
# dswx_hls.py:3385-3461; we support the standard polar grids explicitly)
# ---------------------------------------------------------------------------

def _ps_t(lat, e=None):
    """Snyder (15-9): isometric colatitude function t(phi), north aspect."""
    if e is None:
        e = _E
    s = np.sin(lat)
    return np.tan(np.pi / 4 - lat / 2) \
        * ((1 + e * s) / (1 - e * s)) ** (e / 2)


def _ps_rho_per_t(lat_ts_abs, k0=None, ell='WGS84'):
    """rho/t: variant B (k=1 at the standard parallel lat_ts) when
    ``k0`` is None, else variant A (scale k0 at the pole — UPS; EPSG
    Guidance Note 7-2 eq. for rho)."""
    a, e2, e = _ell_consts(ell)
    if k0 is not None:
        return (2.0 * a * k0
                / np.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e)))
    lat_f = np.radians(lat_ts_abs)
    m_f = np.cos(lat_f) / np.sqrt(1 - e2 * np.sin(lat_f) ** 2)
    return a * m_f / _ps_t(np.float64(lat_f), e)


def polar_stereo_forward(lat_deg, lon_deg, lat_ts, lon0, fe, fn, north,
                         k0=None, ell='WGS84'):
    """Geographic -> polar stereographic E/N, float64 (variant B,
    or variant A / UPS when ``k0`` is given)."""
    _a, _e2, e = _ell_consts(ell)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lam0 = np.radians(lon0)
    if not north:
        lat = -lat
        lon = -lon
        lam0 = -lam0
    rho = _ps_rho_per_t(None if lat_ts is None else abs(lat_ts), k0,
                        ell) * _ps_t(lat, e)
    theta = np.arctan2(np.sin(lon - lam0), np.cos(lon - lam0))
    x = rho * np.sin(theta)
    y = -rho * np.cos(theta)
    if not north:
        x, y = -x, -y
    return fe + x, fn + y


def polar_stereo_inverse(x, y, lat_ts, lon0, fe, fn, north, k0=None,
                         ell='WGS84'):
    """Polar stereographic E/N -> geographic lat/lon degrees (variant
    B, or variant A / UPS when ``k0`` is given)."""
    _a, _e2, e = _ell_consts(ell)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    lam0 = np.radians(lon0)
    if not north:
        x, y, lam0 = -x, -y, -lam0
    rho = np.hypot(x, y)
    t = rho / _ps_rho_per_t(None if lat_ts is None else abs(lat_ts), k0,
                            ell)
    # iterate phi = pi/2 - 2 atan(t ((1-e sin phi)/(1+e sin phi))^(e/2))
    lat = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(8):
        s = np.sin(lat)
        lat = np.pi / 2 - 2 * np.arctan(
            t * ((1 - e * s) / (1 + e * s)) ** (e / 2))
    lon = lam0 + np.arctan2(x, -y)
    lat_deg = np.degrees(lat)
    lon_deg = np.degrees(lon)
    if not north:
        lat_deg = -lat_deg
        lon_deg = -lon_deg
    lon_deg = (lon_deg + 180.0) % 360.0 - 180.0
    return lat_deg, lon_deg



def _merc_k0_from_lat_ts(lat_ts, ell):
    """Mercator variant B -> variant A: equivalent scale at the equator
    k0 = m(lat_ts) = cos(lat_ts)/sqrt(1 - e2 sin^2 lat_ts)."""
    _a, e2, _e = _ell_consts(ell)
    s = np.sin(np.radians(lat_ts))
    return float(np.cos(np.radians(lat_ts))
                 / np.sqrt(1.0 - e2 * s * s))




def lcc_forward(lat_deg, lon_deg, ell, lat0, lon0, sp1, sp2, fe, fn,
                k0=1.0):
    """Geographic -> Lambert Conformal Conic E/N, float64 (Snyder
    15-1..15-5 ellipsoidal, 2SP; the 1SP variant is sp1 == sp2 == lat0
    with scale ``k0`` at the origin)."""
    a, e2, e = _ell_consts(ell)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    p0, p1, p2 = (np.radians(v) for v in (lat0, sp1, sp2))
    s1, s2 = np.sin(p1), np.sin(p2)
    m1 = np.cos(p1) / np.sqrt(1.0 - e2 * s1 * s1)
    m2 = np.cos(p2) / np.sqrt(1.0 - e2 * s2 * s2)
    t0, t1, t2 = (_lcc_t(p, e) for p in (p0, p1, p2))
    if sp1 == sp2:
        n = np.sin(p1)
    else:
        n = (np.log(m1) - np.log(m2)) / (np.log(t1) - np.log(t2))
    F = k0 * m1 / (n * t1 ** n)
    rho0 = a * F * t0 ** n
    rho = a * F * _lcc_t(lat, e) ** n
    theta = n * _wrap_pi(lon - np.radians(lon0))
    return fe + rho * np.sin(theta), fn + rho0 - rho * np.cos(theta)


def lcc_inverse(x, y, ell, lat0, lon0, sp1, sp2, fe, fn, k0=1.0):
    """Lambert Conformal Conic E/N -> geographic lat/lon degrees
    (2SP, or 1SP via sp1 == sp2 == lat0 + ``k0``)."""
    a, e2, e = _ell_consts(ell)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    p0, p1, p2 = (np.radians(v) for v in (lat0, sp1, sp2))
    s1, s2 = np.sin(p1), np.sin(p2)
    m1 = np.cos(p1) / np.sqrt(1.0 - e2 * s1 * s1)
    m2 = np.cos(p2) / np.sqrt(1.0 - e2 * s2 * s2)
    t0, t1, t2 = (_lcc_t(p, e) for p in (p0, p1, p2))
    if sp1 == sp2:
        n = np.sin(p1)
    else:
        n = (np.log(m1) - np.log(m2)) / (np.log(t1) - np.log(t2))
    F = k0 * m1 / (n * t1 ** n)
    rho0 = a * F * t0 ** n
    sgn = 1.0 if n >= 0 else -1.0
    rho = sgn * np.hypot(x, rho0 - y)
    theta = np.arctan2(sgn * x, sgn * (rho0 - y))
    t = (rho / (a * F)) ** (1.0 / n)
    # same conformal-latitude iteration as polar stereographic
    lat = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(8):
        s = np.sin(lat)
        lat = np.pi / 2 - 2 * np.arctan(
            t * ((1.0 - e * s) / (1.0 + e * s)) ** (e / 2))
    lon = np.radians(lon0) + theta / n
    return np.degrees(lat), np.degrees(_wrap_pi(lon))


def mercator_forward(lat_deg, lon_deg, ell, lon0, k0, fe, fn):
    """Geographic -> Mercator E/N (ellipsoidal, EPSG variant A; variant
    B callers fold lat_ts into ``k0`` = m(lat_ts))."""
    a, _e2, e = _ell_consts(ell)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    dlon = _wrap_pi(lon - np.radians(lon0))
    x = fe + a * k0 * dlon
    y = fn - a * k0 * np.log(_lcc_t(lat, e))
    return x, y


def mercator_inverse(x, y, ell, lon0, k0, fe, fn):
    """Mercator E/N -> geographic lat/lon degrees."""
    a, _e2, e = _ell_consts(ell)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    t = np.exp(-y / (a * k0))
    lat = np.pi / 2 - 2 * np.arctan(t)
    for _ in range(8):
        s = np.sin(lat)
        lat = np.pi / 2 - 2 * np.arctan(
            t * ((1.0 - e * s) / (1.0 + e * s)) ** (e / 2))
    lon = np.radians(lon0) + x / (a * k0)
    return np.degrees(lat), np.degrees(_wrap_pi(lon))


def web_mercator_forward(lat_deg, lon_deg):
    """WGS84 geographic -> EPSG:3857 (spherical formulas, R = a, on
    geodetic latitude — the 'popular visualisation' definition)."""
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    return _A * _wrap_pi(lon), _A * np.log(np.tan(np.pi / 4 + lat / 2))


def web_mercator_inverse(x, y):
    """EPSG:3857 -> WGS84 geographic lat/lon degrees."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    lat = np.degrees(2.0 * np.arctan(np.exp(y / _A)) - np.pi / 2)
    lon = np.degrees(_wrap_pi(x / _A))
    return lat, lon


# --------------------------------------------------------------------------
# Hotine Oblique Mercator (EPSG methods 9812 variant A / 9815 variant B
# "azimuth center") — the projection of the US State Plane Alaska
# zone 1, Malaysian RSO and Timbalai (Borneo) grids — and the Swiss
# Oblique Mercator / Rosenmund double projection (PROJ ``somerc``) used
# by CH1903 LV03 / CH1903+ LV95. The reference reaches all of these
# through OSR (any-SRS contract, dswx_hls.py:3385-3461). Formulas per
# EPSG Guidance Note 7-2 (verified against its Timbalai 1948 RSO Borneo
# worked example) and PROJ's somerc derivation (conformal
# sphere double projection), tests/test_crs_omerc.py.

def _omerc_consts(ell, latc, lonc, alpha, gamma, k0):
    a, e2, e = _ell_consts(ell)
    phic = np.radians(latc)
    alphac = np.radians(alpha)
    sin_c, cos_c = np.sin(phic), np.cos(phic)
    B = np.sqrt(1.0 + e2 * cos_c ** 4 / (1.0 - e2))
    A = a * B * k0 * np.sqrt(1.0 - e2) / (1.0 - e2 * sin_c * sin_c)
    t0 = np.tan(np.pi / 4.0 - phic / 2.0) / (
        (1.0 - e * sin_c) / (1.0 + e * sin_c)) ** (e / 2.0)
    D = B * np.sqrt(1.0 - e2) / (
        cos_c * np.sqrt(1.0 - e2 * sin_c * sin_c))
    D2 = max(D * D, 1.0)
    sign = 1.0 if latc >= 0 else -1.0
    F = D + np.sqrt(D2 - 1.0) * sign
    H = F * t0 ** B
    G = (F - 1.0 / F) / 2.0
    gamma0 = np.arcsin(np.sin(alphac) / D)
    lam0 = np.radians(lonc) - np.arcsin(
        np.clip(G * np.tan(gamma0), -1.0, 1.0)) / B
    if abs(abs(alpha) - 90.0) < 1e-9:
        raise ValueError(
            'Hotine oblique Mercator with azimuth 90 degrees is the '
            'Swiss oblique Mercator — use the somerc family')
    uc = (A / B) * np.arctan2(np.sqrt(D2 - 1.0),
                              np.cos(alphac)) * sign
    return A, B, e, H, gamma0, lam0, uc, sign


def omerc_forward(lat_deg, lon_deg, ell, latc, lonc, alpha, gamma,
                  k0, fe, fn, variant_b):
    """Hotine Oblique Mercator geographic degrees -> E/N (EPSG 9812
    variant A when ``variant_b`` is false, 9815 'azimuth center' when
    true; ``gamma`` is the rectified-grid angle)."""
    A, B, e, H, gamma0, lam0, uc, sign = _omerc_consts(
        ell, latc, lonc, alpha, gamma, k0)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    t = np.tan(np.pi / 4.0 - lat / 2.0) / (
        (1.0 - e * np.sin(lat)) / (1.0 + e * np.sin(lat))) ** (e / 2.0)
    Q = H / t ** B
    S = (Q - 1.0 / Q) / 2.0
    T = (Q + 1.0 / Q) / 2.0
    dlam = _wrap_pi(lon - lam0)
    V = np.sin(B * dlam)
    U = (-V * np.cos(gamma0) + S * np.sin(gamma0)) / T
    v = A * np.log((1.0 - U) / (1.0 + U)) / (2.0 * B)
    u = A * np.arctan2(S * np.cos(gamma0) + V * np.sin(gamma0),
                       np.cos(B * dlam)) / B
    if variant_b:
        u = u - abs(uc) * sign
    gam = np.radians(gamma)
    E = v * np.cos(gam) + u * np.sin(gam) + fe
    N = u * np.cos(gam) - v * np.sin(gam) + fn
    return E, N


def omerc_inverse(x, y, ell, latc, lonc, alpha, gamma, k0, fe, fn,
                  variant_b):
    """Hotine Oblique Mercator E/N -> geographic degrees."""
    A, B, e, H, gamma0, lam0, uc, sign = _omerc_consts(
        ell, latc, lonc, alpha, gamma, k0)
    gam = np.radians(gamma)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    v = x * np.cos(gam) - y * np.sin(gam)
    u = y * np.cos(gam) + x * np.sin(gam)
    if variant_b:
        u = u + abs(uc) * sign
    Q = np.exp(-B * v / A)
    S = (Q - 1.0 / Q) / 2.0
    T = (Q + 1.0 / Q) / 2.0
    V = np.sin(B * u / A)
    U = (V * np.cos(gamma0) + S * np.sin(gamma0)) / T
    t = (H / np.sqrt((1.0 + U) / (1.0 - U))) ** (1.0 / B)
    # invert t = tan(pi/4 - phi/2)/((1-e sin phi)/(1+e sin phi))^(e/2):
    # psi = -ln t is the isometric latitude
    lat = _lat_from_isometric(-np.log(t), e)
    lon = lam0 - np.arctan2(S * np.cos(gamma0) - V * np.sin(gamma0),
                            np.cos(B * u / A)) / B
    return np.degrees(lat), np.degrees(_wrap_pi(lon))


def _somerc_consts(ell, lat0, k0):
    a, e2, e = _ell_consts(ell)
    phi0 = np.radians(lat0)
    sp, cp = np.sin(phi0), np.cos(phi0)
    c = np.sqrt(1.0 + e2 * cp ** 4 / (1.0 - e2))
    sinp0 = sp / c
    phip0 = np.arcsin(sinp0)
    K = (np.log(np.tan(np.pi / 4.0 + phip0 / 2.0))
         - c * _isometric_lat(phi0, e))
    kR = k0 * a * np.sqrt(1.0 - e2) / (1.0 - e2 * sp * sp)
    return e, c, sinp0, np.cos(phip0), K, kR


def somerc_forward(lat_deg, lon_deg, ell, lat0, lon0, k0, fe, fn):
    """Swiss Oblique Mercator (Rosenmund double projection, PROJ
    ``somerc``; EPSG 9815 with azimuth 90 as the CH1903 grids use it):
    geographic degrees -> E/N."""
    e, c, sinp0, cosp0, K, kR = _somerc_consts(ell, lat0, k0)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = _wrap_pi(np.radians(np.asarray(lon_deg, dtype=np.float64))
                   - np.radians(lon0))
    phip = 2.0 * np.arctan(
        np.exp(c * _isometric_lat(lat, e) + K)) - np.pi / 2.0
    lamp = c * lon
    cp = np.cos(phip)
    phipp = np.arcsin(cosp0 * np.sin(phip)
                      - sinp0 * cp * np.cos(lamp))
    lampp = np.arcsin(np.clip(cp * np.sin(lamp) / np.cos(phipp),
                              -1.0, 1.0))
    E = kR * lampp + fe
    N = kR * np.log(np.tan(np.pi / 4.0 + phipp / 2.0)) + fn
    return E, N


def somerc_inverse(x, y, ell, lat0, lon0, k0, fe, fn):
    """Swiss Oblique Mercator E/N -> geographic degrees."""
    e, c, sinp0, cosp0, K, kR = _somerc_consts(ell, lat0, k0)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    phipp = 2.0 * np.arctan(np.exp(y / kR)) - np.pi / 2.0
    lampp = x / kR
    cp = np.cos(phipp)
    phip = np.arcsin(cosp0 * np.sin(phipp)
                     + sinp0 * cp * np.cos(lampp))
    lamp = np.arcsin(np.clip(cp * np.sin(lampp) / np.cos(phip),
                             -1.0, 1.0))
    # invert phip = 2 atan(exp(c psi(phi) + K)) - pi/2
    psi = (np.log(np.tan(np.pi / 4.0 + phip / 2.0)) - K) / c
    lat = _lat_from_isometric(psi, e)
    lon = np.radians(lon0) + lamp / c
    return np.degrees(lat), np.degrees(_wrap_pi(lon))



# --------------------------------------------------------------------------
# Krovak (EPSG method 9819) — the S-JTSK oblique conformal conic of the
# Czech and Slovak national grids (EPSG:5514 Krovak East North, the CRS
# Czech DEM/landcover deliveries ship in). Formulas per EPSG Guidance
# Note 7-2; east-north axis convention (southing/westing negated), the
# way GDAL presents EPSG:5514 rasters.

def _krovak_consts(ell, latc, lonc, alphac, latp, k0):
    a, e2, e = _ell_consts(ell)
    phic = np.radians(latc)
    sin_c = np.sin(phic)
    A = a * np.sqrt(1.0 - e2) / (1.0 - e2 * sin_c * sin_c)
    B = np.sqrt(1.0 + e2 * np.cos(phic) ** 4 / (1.0 - e2))
    gamma0 = np.arcsin(sin_c / B)
    t0 = (np.tan(np.pi / 4.0 + gamma0 / 2.0)
          * ((1.0 + e * sin_c) / (1.0 - e * sin_c)) ** (e * B / 2.0)
          / np.tan(np.pi / 4.0 + phic / 2.0) ** B)
    phip = np.radians(latp)
    n = np.sin(phip)
    r0 = k0 * A / np.tan(phip)
    return e, A, B, gamma0, t0, n, r0, phip


def krovak_forward(lat_deg, lon_deg, ell, latc, lonc, alphac, latp,
                   k0, fe, fn):
    """Krovak geographic degrees -> E/N (east-north convention:
    E = -westing + fe, N = -southing + fn)."""
    e, _A, B, _g0, t0, n, r0, phip = _krovak_consts(
        ell, latc, lonc, alphac, latp, k0)
    ac = np.radians(alphac)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    esp = e * np.sin(lat)
    U = 2.0 * (np.arctan(
        t0 * np.tan(lat / 2.0 + np.pi / 4.0) ** B
        / ((1.0 + esp) / (1.0 - esp)) ** (e * B / 2.0)) - np.pi / 4.0)
    V = B * _wrap_pi(np.radians(lonc) - lon)
    T = np.arcsin(np.cos(ac) * np.sin(U)
                  + np.sin(ac) * np.cos(U) * np.cos(V))
    D = np.arcsin(np.clip(np.cos(U) * np.sin(V) / np.cos(T),
                          -1.0, 1.0))
    theta = n * D
    r = (r0 * np.tan(np.pi / 4.0 + phip / 2.0) ** n
         / np.tan(T / 2.0 + np.pi / 4.0) ** n)
    southing = r * np.cos(theta)
    westing = r * np.sin(theta)
    return -westing + fe, -southing + fn


def krovak_inverse(x, y, ell, latc, lonc, alphac, latp, k0, fe, fn):
    """Krovak E/N (east-north convention) -> geographic degrees."""
    e, _A, B, _g0, t0, n, r0, phip = _krovak_consts(
        ell, latc, lonc, alphac, latp, k0)
    ac = np.radians(alphac)
    westing = -(np.asarray(x, dtype=np.float64) - fe)
    southing = -(np.asarray(y, dtype=np.float64) - fn)
    r = np.hypot(southing, westing)
    theta = np.arctan2(westing, southing)
    D = theta / n
    T = 2.0 * (np.arctan(
        (r0 / r) ** (1.0 / n)
        * np.tan(np.pi / 4.0 + phip / 2.0)) - np.pi / 4.0)
    U = np.arcsin(np.cos(ac) * np.sin(T)
                  - np.sin(ac) * np.cos(T) * np.cos(D))
    V = np.arcsin(np.clip(np.cos(T) * np.sin(D) / np.cos(U),
                          -1.0, 1.0))
    # latitude from U by the EPSG fixed-point iteration
    lat = U
    for _ in range(10):
        esp = e * np.sin(lat)
        lat = 2.0 * (np.arctan(
            t0 ** (-1.0 / B)
            * np.tan(U / 2.0 + np.pi / 4.0) ** (1.0 / B)
            * ((1.0 + esp) / (1.0 - esp)) ** (e / 2.0)) - np.pi / 4.0)
    lon = np.radians(lonc) - V / B
    return np.degrees(lat), np.degrees(_wrap_pi(lon))




# --------------------------------------------------------------------------
# Oblique Stereographic (EPSG method 9809, PROJ ``sterea``) — the double
# projection (ellipsoid -> conformal sphere -> stereographic) of the
# Dutch RD New grid (EPSG:28992), the CRS Dutch DEM/ancillary deliveries
# ship in. Formulas per EPSG Guidance Note 7-2.

def _sterea_consts(ell, lat0):
    a, e2, e = _ell_consts(ell)
    phi0 = np.radians(lat0)
    s0 = np.sin(phi0)
    rho0 = a * (1.0 - e2) / (1.0 - e2 * s0 * s0) ** 1.5
    nu0 = a / np.sqrt(1.0 - e2 * s0 * s0)
    R = np.sqrt(rho0 * nu0)
    n = np.sqrt(1.0 + e2 * np.cos(phi0) ** 4 / (1.0 - e2))
    S1 = (1.0 + s0) / (1.0 - s0)
    S2 = (1.0 - e * s0) / (1.0 + e * s0)
    w1 = (S1 * S2 ** e) ** n
    sin_chi00 = (w1 - 1.0) / (w1 + 1.0)
    c = ((n + s0) * (1.0 - sin_chi00)
         / ((n - s0) * (1.0 + sin_chi00)))
    w2 = c * w1
    chi0 = np.arcsin((w2 - 1.0) / (w2 + 1.0))
    return e, n, c, R, chi0


def sterea_forward(lat_deg, lon_deg, ell, lat0, lon0, k0, fe, fn):
    """Oblique Stereographic geographic degrees -> E/N (EPSG 9809)."""
    e, n, c, R, chi0 = _sterea_consts(ell, lat0)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    dlam = n * _wrap_pi(np.radians(np.asarray(lon_deg,
                                              dtype=np.float64))
                        - np.radians(lon0))
    sp = np.sin(lat)
    Sa = (1.0 + sp) / (1.0 - sp)
    Sb = (1.0 - e * sp) / (1.0 + e * sp)
    w = c * (Sa * Sb ** e) ** n
    chi = np.arcsin((w - 1.0) / (w + 1.0))
    B = (1.0 + np.sin(chi) * np.sin(chi0)
         + np.cos(chi) * np.cos(chi0) * np.cos(dlam))
    E = fe + 2.0 * R * k0 * np.cos(chi) * np.sin(dlam) / B
    N = fn + 2.0 * R * k0 * (np.sin(chi) * np.cos(chi0)
                             - np.cos(chi) * np.sin(chi0)
                             * np.cos(dlam)) / B
    return E, N


def sterea_inverse(x, y, ell, lat0, lon0, k0, fe, fn):
    """Oblique Stereographic E/N -> geographic degrees (EPSG 9809)."""
    e, n, c, R, chi0 = _sterea_consts(ell, lat0)
    Ep = np.asarray(x, dtype=np.float64) - fe
    Np = np.asarray(y, dtype=np.float64) - fn
    g = 2.0 * R * k0 * np.tan(np.pi / 4.0 - chi0 / 2.0)
    h = 4.0 * R * k0 * np.tan(chi0) + g
    i = np.arctan2(Ep, h + Np)
    j = np.arctan2(Ep, g - Np) - i
    chi = chi0 + 2.0 * np.arctan(
        (Np - Ep * np.tan(j / 2.0)) / (2.0 * R * k0))
    dlam = j + 2.0 * i
    lon = np.radians(lon0) + dlam / n
    # conformal-sphere isometric latitude back to the geodetic latitude
    # by the EPSG fixed-point iteration
    psi = 0.5 * np.log((1.0 + np.sin(chi))
                       / (c * (1.0 - np.sin(chi)))) / n
    lat = 2.0 * np.arctan(np.exp(psi)) - np.pi / 2.0
    e2 = e * e
    for _ in range(10):
        esp = e * np.sin(lat)
        psi_i = np.log(np.tan(lat / 2.0 + np.pi / 4.0)
                       * ((1.0 - esp) / (1.0 + esp)) ** (e / 2.0))
        lat = lat - ((psi_i - psi) * np.cos(lat)
                     * (1.0 - esp * esp) / (1.0 - e2))
    return np.degrees(lat), np.degrees(_wrap_pi(lon))


