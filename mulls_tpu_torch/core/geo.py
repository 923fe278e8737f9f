"""Geodesy: geodetic <-> cartesian converters and UTM projection — a copy
of ``mulls_tpu/core/geo.py`` (numpy only, so the port keeps its own).

Capability parity with the reference's geomatics extras:

* :func:`blh2xyz` / :func:`xyz2blh` / :func:`xyz2neu` — the offline
  coordinate converters (`python/geo_tran/blh2xyz.py`, `xyz2blh.py`,
  `xyz2neu.py`).
* :func:`utm_forward` / :func:`utm_inverse` — WGS84 Universal Transverse
  Mercator, the projection `include/nav/geo_tran.h:28-96`
  (`GeoTransform::GetTransform`) obtains from proj4.  Implemented here as
  the Karney–Krüger series (terms through n^6, sub-mm agreement with
  proj4), so no external projection library is needed.
* :func:`gnss_to_pose` — 6-DoF pose from an OXTS/GNSS record (roll, pitch,
  yaw rotation + UTM-projected translation), parity with
  `GeoTransform::GetTransform` (`geo_tran.h:28-118`).

Everything is plain numpy (host-side, tiny inputs — these run once per
trajectory, not per point).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# WGS84 (`python/geo_tran/blh2xyz.py:20-21`)
WGS84_A = 6378137.0
WGS84_B = 6356752.314245
WGS84_F = 1.0 - WGS84_B / WGS84_A          # flattening
WGS84_E2 = 1.0 - (WGS84_B / WGS84_A) ** 2  # first eccentricity squared

UTM_K0 = 0.9996
UTM_FALSE_EASTING = 500000.0
UTM_FALSE_NORTHING_S = 10000000.0


def blh2xyz(lat_deg, lon_deg, height) -> Tuple[np.ndarray, ...]:
    """Geodetic (deg, deg, m) -> ECEF XYZ (`blh2xyz.py:25-60`)."""
    lat = np.radians(np.asarray(lat_deg, np.float64))
    lon = np.radians(np.asarray(lon_deg, np.float64))
    h = np.asarray(height, np.float64)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    x = (n + h) * np.cos(lat) * np.cos(lon)
    y = (n + h) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + h) * np.sin(lat)
    return x, y, z


def xyz2blh(x, y, z) -> Tuple[np.ndarray, ...]:
    """ECEF XYZ -> geodetic (deg, deg, m), iterative latitude
    (`xyz2blh.py` semantics)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    z = np.asarray(z, np.float64)
    lon = np.arctan2(y, x)
    p = np.sqrt(x * x + y * y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E2))
    for _ in range(10):
        n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
        h = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E2 * n / (n + h)))
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * np.sin(lat) ** 2)
    h = p / np.cos(lat) - n
    return np.degrees(lat), np.degrees(lon), h


def xyz2neu(x0, y0, z0, x, y, z) -> Tuple[np.ndarray, ...]:
    """ECEF -> local site-centred North/East/Up at (x0,y0,z0)
    (`xyz2neu.py:18-44`)."""
    lat_d, lon_d, _ = xyz2blh(x0, y0, z0)
    lat = np.radians(lat_d)
    lon = np.radians(lon_d)
    dx = np.asarray(x, np.float64) - x0
    dy = np.asarray(y, np.float64) - y0
    dz = np.asarray(z, np.float64) - z0
    north = (-np.sin(lat) * np.cos(lon) * dx
             - np.sin(lat) * np.sin(lon) * dy + np.cos(lat) * dz)
    east = -np.sin(lon) * dx + np.cos(lon) * dy
    up = (np.cos(lat) * np.cos(lon) * dx
          + np.cos(lat) * np.sin(lon) * dy + np.sin(lat) * dz)
    return north, east, up


def utm_zone(lon_deg: float) -> int:
    """Standard 6-degree UTM zone number for a longitude."""
    return int((math.floor((float(lon_deg) + 180.0) / 6.0) % 60) + 1)


def _kruger_constants():
    n = WGS84_F / (2.0 - WGS84_F)
    n2, n3, n4, n5, n6 = n**2, n**3, n**4, n**5, n**6
    A = WGS84_A / (1 + n) * (1 + n2 / 4 + n4 / 64 + n6 / 256)
    alpha = np.array([
        n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180
        - 127 * n5 / 288 + 7891 * n6 / 37800,
        13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630
        - 1983433 * n6 / 1935360,
        61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880
        + 167603 * n6 / 181440,
        49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
        34729 * n5 / 80640 - 3418889 * n6 / 1995840,
        212378941 * n6 / 319334400])
    beta = np.array([
        n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512
        + 96199 * n6 / 604800,
        n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105
        - 1118711 * n6 / 3870720,
        17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480
        + 5569 * n6 / 90720,
        4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
        4583 * n5 / 161280 - 108847 * n6 / 3991680,
        20648693 * n6 / 638668800])
    return n, A, alpha, beta


_N, _A_BAR, _ALPHA, _BETA = _kruger_constants()


def utm_forward(lat_deg, lon_deg, zone: int = None
                ) -> Tuple[np.ndarray, np.ndarray, int]:
    """WGS84 lat/lon (deg) -> UTM (easting, northing, zone).

    Karney–Krüger transverse Mercator series; matches proj4's
    ``+proj=utm`` (used by `geo_tran.h:72-80`) to sub-mm.  Southern
    hemisphere gets the 10,000 km false northing.
    """
    lat = np.radians(np.asarray(lat_deg, np.float64))
    lon = np.asarray(lon_deg, np.float64)
    if zone is None:
        zone = utm_zone(np.min(lon))
    lon0 = math.radians((zone - 1) * 6 - 180 + 3)
    lam = np.radians(lon) - lon0

    n = _N
    s = np.sin(lat)
    c2 = 2.0 * math.sqrt(n) / (1.0 + n)
    t = np.sinh(np.arctanh(s) - c2 * np.arctanh(c2 * s))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.sqrt(t * t + np.cos(lam) ** 2))
    j = np.arange(1, 7)[:, None]
    xi = xi_p + np.sum(_ALPHA[:, None] * np.sin(2 * j * xi_p)
                       * np.cosh(2 * j * eta_p), 0)
    eta = eta_p + np.sum(_ALPHA[:, None] * np.cos(2 * j * xi_p)
                         * np.sinh(2 * j * eta_p), 0)
    easting = UTM_FALSE_EASTING + UTM_K0 * _A_BAR * eta
    northing = UTM_K0 * _A_BAR * xi
    northing = np.where(np.asarray(lat_deg) < 0,
                        northing + UTM_FALSE_NORTHING_S, northing)
    return np.squeeze(easting), np.squeeze(northing), zone


def utm_inverse(easting, northing, zone: int, south: bool = False
                ) -> Tuple[np.ndarray, np.ndarray]:
    """UTM -> WGS84 lat/lon (deg); inverse Krüger series."""
    e = np.asarray(easting, np.float64)
    nn = np.asarray(northing, np.float64)
    if south:
        nn = nn - UTM_FALSE_NORTHING_S
    xi = nn / (UTM_K0 * _A_BAR)
    eta = (e - UTM_FALSE_EASTING) / (UTM_K0 * _A_BAR)
    j = np.arange(1, 7)[:, None]
    xi_p = xi - np.sum(_BETA[:, None] * np.sin(2 * j * xi)
                       * np.cosh(2 * j * eta), 0)
    eta_p = eta - np.sum(_BETA[:, None] * np.cos(2 * j * xi)
                         * np.sinh(2 * j * eta), 0)
    # conformal latitude chi, then invert the conformal map by Newton on
    # tau = tan(lat):  tau' = tau sqrt(1+sigma^2) - sigma sqrt(1+tau^2)
    tau_p = np.sin(xi_p) / np.hypot(np.sinh(eta_p), np.cos(xi_p))  # tan(chi)
    e1 = math.sqrt(WGS84_E2)
    tau = tau_p / (1.0 - WGS84_E2)
    for _ in range(8):
        sigma = np.sinh(e1 * np.arctanh(e1 * tau / np.sqrt(1 + tau * tau)))
        f = tau * np.sqrt(1 + sigma * sigma) - sigma * np.sqrt(1 + tau * tau)
        dtau = ((tau_p - f) * (1 + (1 - WGS84_E2) * tau * tau)
                / ((1 - WGS84_E2) * np.sqrt((1 + f * f) * (1 + tau * tau))))
        tau = tau + dtau
    lat = np.arctan(tau)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    lon0 = (zone - 1) * 6 - 180 + 3
    return (np.degrees(np.squeeze(lat)),
            np.degrees(np.squeeze(lam)) + lon0)


def gnss_trajectory_to_poses(records) -> np.ndarray:
    """[N] iterable of (lat, lon, alt, roll, pitch, yaw) degree records ->
    [N, 4, 4] poses.  The UTM zone is LOCKED from the first record so a
    trajectory crossing a 6-degree zone boundary stays in one continuous
    projection (per-record zones would make the easting jump ~500 km at
    the boundary).  Mirrors the reference's fixed `+zone=51` choice
    (`geo_tran.h:72`) without hard-coding the zone."""
    records = list(records)
    if not records:
        return np.zeros((0, 4, 4))
    zone = utm_zone(records[0][1])
    return np.stack([gnss_to_pose(*r, zone=zone) for r in records])


def gnss_to_pose(lat_deg: float, lon_deg: float, alt: float,
                 roll_deg: float, pitch_deg: float, yaw_deg: float,
                 zone: int = None) -> np.ndarray:
    """6-DoF pose from an OXTS/GNSS record — UTM-projected translation +
    Rz(yaw) Ry(pitch) Rx(roll) rotation, parity with
    `GeoTransform::GetTransform` (`geo_tran.h:28-118`).

    For trajectories use :func:`gnss_trajectory_to_poses` (or pass an
    explicit ``zone``): the default picks the zone from THIS record's
    longitude, which is discontinuous across zone boundaries."""
    roll = math.radians(roll_deg)
    pitch = math.radians(pitch_deg)
    yaw = math.radians(yaw_deg)
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    easting, northing, _ = utm_forward(lat_deg, lon_deg, zone)
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = [float(easting), float(northing), float(alt)]
    return T
