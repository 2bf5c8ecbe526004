"""Equal-area projection families — Albers Conic, Lambert Azimuthal,
Cylindrical Equal Area, sinusoidal — plus the (equidistant) world
Equirectangular grid.

Split out of crs.py (round 5); formulas per Snyder 1987 ch. 10/14/24/30
and EPSG Guidance Note 7-2, verified against their worked examples in
tests/test_geo.py.
"""

import numpy as np

from .crs_core import (_ell_consts, _lat_from_merid, _merid_arc,
                       _phi_from_q, _q_authalic, _sinu_ell, _wrap_pi)

# ---------------------------------------------------------------------------
# Equal-area projections (Albers Conic, Lambert Azimuthal) — the national
# land-product grids a delivered DEM/landcover ancillary plausibly arrives
# in: NLCD/LANDFIRE ship in NAD83 Conus Albers, Geoscience Australia in
# GDA94 Australian Albers, EU-DEM/Corine in ETRS89-LAEA, NSIDC snow/ice
# products in EASE-Grid 2.0. The reference accepts them implicitly through
# OSR (dswx_hls.py:3385-3461). Ellipsoidal forms per Snyder 1987 ch. 14/24
# and EPSG Guidance Note 7-2; datum shifts NAD83/GDA94/ETRS89 <-> WGS84 are
# the null transformation (as OSR applies without datum grids, ~1-2 m).
# ---------------------------------------------------------------------------

def albers_forward(lat_deg, lon_deg, ell, lat0, lon0, sp1, sp2, fe, fn):
    """Geographic -> Albers Equal Area Conic E/N, float64 (Snyder
    14-1..14-5 ellipsoidal; null datum shift to the grid's datum)."""
    a, e2, e = _ell_consts(ell)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    p0, p1, p2 = (np.radians(v) for v in (lat0, sp1, sp2))
    s1, s2 = np.sin(p1), np.sin(p2)
    m1 = np.cos(p1) / np.sqrt(1.0 - e2 * s1 * s1)
    m2 = np.cos(p2) / np.sqrt(1.0 - e2 * s2 * s2)
    q0, q1, q2 = (_q_authalic(p, e, e2) for p in (p0, p1, p2))
    n = (m1 * m1 - m2 * m2) / (q2 - q1)
    C = m1 * m1 + n * q1
    rho0 = a * np.sqrt(C - n * q0) / n
    q = _q_authalic(lat, e, e2)
    rho = a * np.sqrt(np.maximum(C - n * q, 0.0)) / n
    theta = n * _wrap_pi(lon - np.radians(lon0))
    return fe + rho * np.sin(theta), fn + rho0 - rho * np.cos(theta)


def albers_inverse(x, y, ell, lat0, lon0, sp1, sp2, fe, fn):
    """Albers Equal Area Conic E/N -> geographic lat/lon degrees."""
    a, e2, e = _ell_consts(ell)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    p0, p1, p2 = (np.radians(v) for v in (lat0, sp1, sp2))
    s1, s2 = np.sin(p1), np.sin(p2)
    m1 = np.cos(p1) / np.sqrt(1.0 - e2 * s1 * s1)
    m2 = np.cos(p2) / np.sqrt(1.0 - e2 * s2 * s2)
    q0, q1, q2 = (_q_authalic(p, e, e2) for p in (p0, p1, p2))
    n = (m1 * m1 - m2 * m2) / (q2 - q1)
    C = m1 * m1 + n * q1
    rho0 = a * np.sqrt(C - n * q0) / n
    sgn = 1.0 if n >= 0 else -1.0   # Snyder: flip signs when n < 0
    rho = np.hypot(x, rho0 - y)
    theta = np.arctan2(sgn * x, sgn * (rho0 - y))
    q = (C - (rho * n / a) ** 2) / n
    qp = _q_authalic(np.float64(np.pi / 2), e, e2)
    lat = _phi_from_q(q, e, e2, qp)
    lon = np.radians(lon0) + theta / n
    return np.degrees(lat), np.degrees(_wrap_pi(lon))


def laea_forward(lat_deg, lon_deg, ell, lat0, lon0, fe, fn):
    """Geographic -> Lambert Azimuthal Equal Area E/N, float64 (EPSG
    Guidance Note 7-2 oblique form; Snyder 24-23/24 polar aspects)."""
    a, e2, e = _ell_consts(ell)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    dlon = _wrap_pi(np.radians(np.asarray(lon_deg, dtype=np.float64))
                    - np.radians(lon0))
    q = _q_authalic(lat, e, e2)
    qp = _q_authalic(np.float64(np.pi / 2), e, e2)
    if lat0 >= 90.0:     # north polar aspect
        rho = a * np.sqrt(np.maximum(qp - q, 0.0))
        return fe + rho * np.sin(dlon), fn - rho * np.cos(dlon)
    if lat0 <= -90.0:    # south polar aspect
        rho = a * np.sqrt(np.maximum(qp + q, 0.0))
        return fe + rho * np.sin(dlon), fn + rho * np.cos(dlon)
    p0 = np.radians(lat0)
    s0 = np.sin(p0)
    m0 = np.cos(p0) / np.sqrt(1.0 - e2 * s0 * s0)
    b0 = np.arcsin(np.clip(_q_authalic(p0, e, e2) / qp, -1.0, 1.0))
    beta = np.arcsin(np.clip(q / qp, -1.0, 1.0))
    rq = a * np.sqrt(qp / 2.0)
    d = a * m0 / (rq * np.cos(b0))
    denom = (1.0 + np.sin(b0) * np.sin(beta)
             + np.cos(b0) * np.cos(beta) * np.cos(dlon))
    b = rq * np.sqrt(2.0 / np.maximum(denom, 1e-12))
    x = b * d * np.cos(beta) * np.sin(dlon)
    y = (b / d) * (np.cos(b0) * np.sin(beta)
                   - np.sin(b0) * np.cos(beta) * np.cos(dlon))
    return fe + x, fn + y


def laea_inverse(x, y, ell, lat0, lon0, fe, fn):
    """Lambert Azimuthal Equal Area E/N -> geographic lat/lon degrees."""
    a, e2, e = _ell_consts(ell)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    qp = _q_authalic(np.float64(np.pi / 2), e, e2)
    lam0 = np.radians(lon0)
    if lat0 >= 90.0 or lat0 <= -90.0:
        rho = np.hypot(x, y)
        if lat0 >= 90.0:
            q = qp - (rho / a) ** 2
            lon = lam0 + np.arctan2(x, -y)
        else:
            q = (rho / a) ** 2 - qp
            lon = lam0 + np.arctan2(x, y)
        lat = _phi_from_q(q, e, e2, qp)
        return np.degrees(lat), np.degrees(_wrap_pi(lon))
    p0 = np.radians(lat0)
    s0 = np.sin(p0)
    m0 = np.cos(p0) / np.sqrt(1.0 - e2 * s0 * s0)
    b0 = np.arcsin(np.clip(_q_authalic(p0, e, e2) / qp, -1.0, 1.0))
    rq = a * np.sqrt(qp / 2.0)
    d = a * m0 / (rq * np.cos(b0))
    rho = np.hypot(x / d, d * y)
    safe_rho = np.maximum(rho, 1e-12)
    ce = 2.0 * np.arcsin(np.clip(rho / (2.0 * rq), -1.0, 1.0))
    beta = np.arcsin(np.clip(
        np.cos(ce) * np.sin(b0)
        + d * y * np.sin(ce) * np.cos(b0) / safe_rho, -1.0, 1.0))
    lon = lam0 + np.arctan2(
        x * np.sin(ce),
        d * safe_rho * np.cos(b0) * np.cos(ce)
        - d * d * y * np.sin(b0) * np.sin(ce))
    lat = _phi_from_q(qp * np.sin(beta), e, e2, qp)
    # at the projection center rho=0: the trig degenerates -> (lat0,lon0)
    lat = np.where(rho < 1e-12, p0, lat)
    lon = np.where(rho < 1e-12, lam0, lon)
    return np.degrees(lat), np.degrees(_wrap_pi(lon))



def sinusoidal_forward(lat_deg, lon_deg, ell, lon0, fe, fn):
    """Geographic -> sinusoidal E/N, float64 (Snyder ch. 30: sphere
    30-1/30-2 for the MODIS grid R=6371007.181, ellipsoid 30-8/30-9
    for ESRI:54008-style World Sinusoidal). Equal-area."""
    a, e2, _e = _sinu_ell(ell)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    dlon = _wrap_pi(np.radians(np.asarray(lon_deg, dtype=np.float64))
                    - np.radians(lon0))
    s = np.sin(lat)
    x = a * dlon * np.cos(lat) / np.sqrt(1.0 - e2 * s * s)
    return fe + x, fn + _merid_arc(lat, a, e2)


def sinusoidal_inverse(x, y, ell, lon0, fe, fn):
    """Sinusoidal E/N -> geographic lat/lon degrees."""
    a, e2, _e = _sinu_ell(ell)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    lat = _lat_from_merid(y, a, e2)
    s = np.sin(lat)
    c = np.cos(lat)
    dlon = np.where(np.abs(c) < 1e-12, 0.0,
                    x * np.sqrt(1.0 - e2 * s * s)
                    / (a * np.maximum(np.abs(c), 1e-12)) * np.sign(c))
    lon = np.radians(lon0) + dlon
    return np.degrees(lat), np.degrees(_wrap_pi(lon))


def cea_forward(lat_deg, lon_deg, ell, lat_ts, lon0, fe, fn):
    """Geographic -> Lambert Cylindrical Equal Area E/N (EPSG method
    9835, Snyder 10-13/10-14): the EASE-Grid 2.0 global grid
    (EPSG:6933, WGS84, lat_ts 30)."""
    a, e2, e = _ell_consts(ell)
    st = np.sin(np.radians(lat_ts))
    k0 = np.cos(np.radians(lat_ts)) / np.sqrt(1.0 - e2 * st * st)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    dlon = _wrap_pi(np.radians(np.asarray(lon_deg, dtype=np.float64))
                    - np.radians(lon0))
    q = _q_authalic(lat, e, e2)
    return fe + a * k0 * dlon, fn + a * q / (2.0 * k0)


def cea_inverse(x, y, ell, lat_ts, lon0, fe, fn):
    """Lambert Cylindrical Equal Area E/N -> geographic degrees."""
    a, e2, e = _ell_consts(ell)
    st = np.sin(np.radians(lat_ts))
    k0 = np.cos(np.radians(lat_ts)) / np.sqrt(1.0 - e2 * st * st)
    x = np.asarray(x, dtype=np.float64) - fe
    y = np.asarray(y, dtype=np.float64) - fn
    qp = _q_authalic(np.float64(np.pi / 2), e, e2)
    q = 2.0 * k0 * y / a
    lat = _phi_from_q(q, e, e2, qp)
    lon = np.radians(lon0) + x / (a * k0)
    return np.degrees(lat), np.degrees(_wrap_pi(lon))



# --------------------------------------------------------------------------
# Equidistant Cylindrical (EPSG method 1028, PROJ ``eqc``) — the
# projected plate carree of the global-raster grids EPSG:4087 (WGS 84 /
# World Equidistant Cylindrical) and the deprecated-but-circulating
# EPSG:32662. Ellipsoidal formulas per EPSG Guidance Note 7-2 (meridian
# arc northing), matching PROJ >= 7's ellipsoidal eqc.

def _eqc_nu1_cos(e2, lat_ts):
    """cos(lat_ts)/sqrt(1 - e2 sin^2 lat_ts), rejecting the degenerate
    standard parallel at the poles (where the cylinder's radius is 0 and
    the projection is undefined — match the ValueError contract of the
    other degenerate projection parameters)."""
    if abs(lat_ts) >= 90.0 - 1e-9:
        raise ValueError(
            f'equidistant cylindrical standard parallel lat_ts={lat_ts} '
            'is degenerate (|lat_ts| must be < 90 degrees)')
    phi1 = np.radians(lat_ts)
    return np.cos(phi1) / np.sqrt(1.0 - e2 * np.sin(phi1) ** 2)


def eqc_forward(lat_deg, lon_deg, ell, lat_ts, lat0, lon0, fe, fn):
    """Equidistant Cylindrical geographic degrees -> E/N (EPSG 1028)."""
    a, e2, _e = _ell_consts(ell)
    nu1_cos = _eqc_nu1_cos(e2, lat_ts)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    dlam = _wrap_pi(np.radians(np.asarray(lon_deg, dtype=np.float64))
                    - np.radians(lon0))
    E = fe + a * nu1_cos * dlam
    N = fn + _merid_arc(lat, a, e2) - _merid_arc(np.radians(lat0),
                                                 a, e2)
    return E, N


def eqc_inverse(x, y, ell, lat_ts, lat0, lon0, fe, fn):
    """Equidistant Cylindrical E/N -> geographic degrees (EPSG 1028)."""
    a, e2, _e = _ell_consts(ell)
    nu1_cos = _eqc_nu1_cos(e2, lat_ts)
    M = (np.asarray(y, dtype=np.float64) - fn
         + _merid_arc(np.radians(lat0), a, e2))
    lat = _lat_from_merid(M, a, e2)
    lon = (np.radians(lon0)
           + (np.asarray(x, dtype=np.float64) - fe) / (a * nu1_cos))
    return np.degrees(lat), np.degrees(_wrap_pi(lon))


