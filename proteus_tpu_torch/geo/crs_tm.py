"""Transverse Mercator / UTM (Krueger-Karney 6th-order series).

Split out of crs.py (round 5). Accuracy: nanometers over each zone —
far beyond the 30 m pixel grid (reference resolves UTM through OSR,
dswx_hls.py:3385-3461).
"""

import numpy as np
from functools import lru_cache

from .crs_core import (_ELLIPSOIDS, _FALSE_EASTING, _K0, _ell_consts,
                       _wrap_pi)

@lru_cache(maxsize=None)
def _tm_series(ell):
    """Krueger/Karney 6th-order series constants for one ellipsoid:
    (e, e2, a_hat, alpha[6], beta[6])."""
    a, invf = _ELLIPSOIDS[ell]
    f = 1.0 / invf
    e2 = f * (2.0 - f)
    e = np.sqrt(e2)
    _n = f / (2.0 - f)
    a_hat = a / (1 + _n) * (1 + _n ** 2 / 4 + _n ** 4 / 64
                            + _n ** 6 / 256)
    alpha = np.array([
        _n / 2 - 2 * _n ** 2 / 3 + 5 * _n ** 3 / 16 + 41 * _n ** 4 / 180
        - 127 * _n ** 5 / 288 + 7891 * _n ** 6 / 37800,
        13 * _n ** 2 / 48 - 3 * _n ** 3 / 5 + 557 * _n ** 4 / 1440
        + 281 * _n ** 5 / 630 - 1983433 * _n ** 6 / 1935360,
        61 * _n ** 3 / 240 - 103 * _n ** 4 / 140 + 15061 * _n ** 5 / 26880
        + 167603 * _n ** 6 / 181440,
        49561 * _n ** 4 / 161280 - 179 * _n ** 5 / 168
        + 6601661 * _n ** 6 / 7257600,
        34729 * _n ** 5 / 80640 - 3418889 * _n ** 6 / 1995840,
        212378941 * _n ** 6 / 319334400,
    ])
    beta = np.array([
        _n / 2 - 2 * _n ** 2 / 3 + 37 * _n ** 3 / 96 - _n ** 4 / 360
        - 81 * _n ** 5 / 512 + 96199 * _n ** 6 / 604800,
        _n ** 2 / 48 + _n ** 3 / 15 - 437 * _n ** 4 / 1440
        + 46 * _n ** 5 / 105 - 1118711 * _n ** 6 / 3870720,
        17 * _n ** 3 / 480 - 37 * _n ** 4 / 840 - 209 * _n ** 5 / 4480
        + 5569 * _n ** 6 / 90720,
        4397 * _n ** 4 / 161280 - 11 * _n ** 5 / 504
        - 830251 * _n ** 6 / 7257600,
        4583 * _n ** 5 / 161280 - 108847 * _n ** 6 / 3991680,
        20648693 * _n ** 6 / 638668800,
    ])
    return e, e2, a_hat, alpha, beta


def utm_forward(lat_deg, lon_deg, zone, north, ell='WGS84'):
    """Geographic -> UTM easting/northing (float64, vectorized).

    ``ell`` selects the ellipsoid: 'WGS84' (default; EPSG:326xx/327xx)
    or 'GRS80' (NAD83 / ETRS89 UTM)."""
    e, e2, a_hat, alpha, _beta = _tm_series(ell)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lon0 = np.radians(zone * 6.0 - 183.0)
    dlon = np.arctan2(np.sin(lon - lon0), np.cos(lon - lon0))

    sphi = np.sin(lat)
    t = np.sinh(np.arctanh(sphi) - e * np.arctanh(e * sphi))
    xi_p = np.arctan2(t, np.cos(dlon))
    eta_p = np.arctanh(np.sin(dlon) / np.sqrt(1.0 + t * t))

    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi = xi + alpha[j] * np.sin(k * xi_p) * np.cosh(k * eta_p)
        eta = eta + alpha[j] * np.cos(k * xi_p) * np.sinh(k * eta_p)

    x = _FALSE_EASTING + _K0 * a_hat * eta
    y = _K0 * a_hat * xi
    if not north:
        y = y + 10000000.0
    return x, y


def utm_inverse(x, y, zone, north, ell='WGS84'):
    """UTM easting/northing -> geographic lat/lon degrees (float64).

    ``ell``: 'WGS84' (default) or 'GRS80' (NAD83 / ETRS89 UTM)."""
    e, e2, a_hat, _alpha, beta = _tm_series(ell)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if not north:
        y = y - 10000000.0
    xi = y / (_K0 * a_hat)
    eta = (x - _FALSE_EASTING) / (_K0 * a_hat)

    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi_p = xi_p - beta[j] * np.sin(k * xi) * np.cosh(k * eta)
        eta_p = eta_p - beta[j] * np.cos(k * xi) * np.sinh(k * eta)

    sinh_eta = np.sinh(eta_p)
    cos_xi = np.cos(xi_p)
    dlon = np.arctan2(sinh_eta, cos_xi)
    tau_p = np.sin(xi_p) / np.sqrt(sinh_eta ** 2 + cos_xi ** 2)

    # Newton-iterate tau (tan of geodetic latitude) from tau' (Karney)
    tau = tau_p / (1.0 - e2)
    for _ in range(5):
        sigma = np.sinh(e * np.arctanh(e * tau / np.sqrt(1.0 + tau ** 2)))
        tau_p_i = tau * np.sqrt(1.0 + sigma ** 2) \
            - sigma * np.sqrt(1.0 + tau ** 2)
        dtau = ((tau_p - tau_p_i) * (1.0 + (1.0 - e2) * tau ** 2)
                / ((1.0 - e2)
                   * np.sqrt((1.0 + tau_p_i ** 2) * (1.0 + tau ** 2))))
        tau = tau + dtau

    lat = np.degrees(np.arctan(tau))
    lon0 = zone * 6.0 - 183.0
    lon = lon0 + np.degrees(dlon)
    lon = (lon + 180.0) % 360.0 - 180.0
    return lat, lon


def _tm_xi0(lat0_deg, ell):
    """Scaled meridian arc xi(lat0) of the Krueger series (the
    latitude-of-origin northing offset for general TM grids)."""
    _e, _e2, _a_hat, alpha, _beta = _tm_series(ell)
    lat0 = np.radians(np.float64(lat0_deg))
    s = np.sin(lat0)
    e = _e
    t = np.sinh(np.arctanh(s) - e * np.arctanh(e * s))
    xi_p = np.arctan(t)
    xi = xi_p
    for j in range(6):
        xi = xi + alpha[j] * np.sin(2.0 * (j + 1) * xi_p)
    return xi


def tm_forward_general(lat_deg, lon_deg, ell, lat0, lon0, k0, fe, fn):
    """Geographic -> Transverse Mercator E/N with arbitrary parameters
    (latitude/longitude of origin, scale, false easting/northing) on a
    named ellipsoid — the general form behind user-defined TM grids
    (British National Grid, NZTM, Gauss-Krueger zones, ...). Same
    6th-order Krueger series as the UTM engine."""
    e, e2, a_hat, alpha, _beta = _tm_series(ell)
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    lam0 = np.radians(lon0)
    dlon = np.arctan2(np.sin(lon - lam0), np.cos(lon - lam0))
    sphi = np.sin(lat)
    t = np.sinh(np.arctanh(sphi) - e * np.arctanh(e * sphi))
    xi_p = np.arctan2(t, np.cos(dlon))
    eta_p = np.arctanh(np.sin(dlon) / np.sqrt(1.0 + t * t))
    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi = xi + alpha[j] * np.sin(k * xi_p) * np.cosh(k * eta_p)
        eta = eta + alpha[j] * np.cos(k * xi_p) * np.sinh(k * eta_p)
    x = fe + k0 * a_hat * eta
    y = fn + k0 * a_hat * (xi - _tm_xi0(lat0, ell))
    return x, y


def tm_inverse_general(x, y, ell, lat0, lon0, k0, fe, fn):
    """Transverse Mercator E/N with arbitrary parameters ->
    geographic lat/lon degrees."""
    e, e2, a_hat, _alpha, beta = _tm_series(ell)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    xi = (y - fn) / (k0 * a_hat) + _tm_xi0(lat0, ell)
    eta = (x - fe) / (k0 * a_hat)
    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        k = 2.0 * (j + 1)
        xi_p = xi_p - beta[j] * np.sin(k * xi) * np.cosh(k * eta)
        eta_p = eta_p - beta[j] * np.cos(k * xi) * np.sinh(k * eta)
    sinh_eta = np.sinh(eta_p)
    cos_xi = np.cos(xi_p)
    dlon = np.arctan2(sinh_eta, cos_xi)
    tau_p = np.sin(xi_p) / np.sqrt(sinh_eta ** 2 + cos_xi ** 2)
    tau = tau_p / (1.0 - e2)
    for _ in range(5):
        sigma = np.sinh(e * np.arctanh(e * tau / np.sqrt(1.0 + tau ** 2)))
        tau_p_i = tau * np.sqrt(1.0 + sigma ** 2) \
            - sigma * np.sqrt(1.0 + tau ** 2)
        dtau = ((tau_p - tau_p_i) * (1.0 + (1.0 - e2) * tau ** 2)
                / ((1.0 - e2)
                   * np.sqrt((1.0 + tau_p_i ** 2) * (1.0 + tau ** 2))))
        tau = tau + dtau
    lat = np.degrees(np.arctan(tau))
    lon = lon0 + np.degrees(dlon)
    lon = (lon + 180.0) % 360.0 - 180.0
    return lat, lon

