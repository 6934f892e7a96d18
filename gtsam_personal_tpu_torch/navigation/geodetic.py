"""WGS-84 geodetic conversions: (lat, lon, h) -> ECEF -> local ENU.

A numpy copy of gtsam_personal_tpu/navigation/geodetic.py (all of it; the
port keeps its own, so that it imports nothing of the JAX package).
Reference parity: the GeographicLib-backed path of GPSFactor
(navigation/GPSFactor.h:63 uses LocalCartesian to express GPS fixes in a
local frame; SURVEY.md §2.9 navigation row). Standard closed-form WGS-84
formulas — vectorized numpy on host (coordinate conversion is a data-prep
step, not a hot path).
"""

import numpy as np

# WGS-84 ellipsoid
_A = 6378137.0                  # semi-major axis [m]
_F = 1.0 / 298.257223563        # flattening
_E2 = _F * (2.0 - _F)           # first eccentricity squared


def lla_to_ecef(lat_deg, lon_deg, h):
    """Geodetic (degrees, meters) -> ECEF [.., 3]."""
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    h = np.asarray(h, dtype=np.float64)
    sl, cl = np.sin(lat), np.cos(lat)
    N = _A / np.sqrt(1.0 - _E2 * sl * sl)
    x = (N + h) * cl * np.cos(lon)
    y = (N + h) * cl * np.sin(lon)
    z = (N * (1.0 - _E2) + h) * sl
    return np.stack([x, y, z], axis=-1)


def ecef_to_lla(xyz):
    """ECEF [.., 3] -> (lat_deg, lon_deg, h). Bowring/iterative (converges to
    sub-mm in a few iterations)."""
    xyz = np.asarray(xyz, dtype=np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - _E2))
    for _ in range(6):
        sl = np.sin(lat)
        N = _A / np.sqrt(1.0 - _E2 * sl * sl)
        h = p / np.cos(lat) - N
        lat = np.arctan2(z, p * (1.0 - _E2 * N / (N + h)))
    sl = np.sin(lat)
    N = _A / np.sqrt(1.0 - _E2 * sl * sl)
    h = p / np.cos(lat) - N
    return np.degrees(lat), np.degrees(lon), h


def ecef_to_enu(xyz, origin_lla):
    """ECEF points -> ENU coordinates relative to origin (lat, lon, h)."""
    lat0, lon0, h0 = origin_lla
    o = lla_to_ecef(lat0, lon0, h0)
    d = np.asarray(xyz, dtype=np.float64) - o
    lat = np.radians(lat0)
    lon = np.radians(lon0)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    R = np.array([[-so, co, 0.0],
                  [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])
    return d @ R.T


def enu_to_ecef(enu, origin_lla):
    lat0, lon0, h0 = origin_lla
    o = lla_to_ecef(lat0, lon0, h0)
    lat = np.radians(lat0)
    lon = np.radians(lon0)
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    R = np.array([[-so, co, 0.0],
                  [-sl * co, -sl * so, cl],
                  [cl * co, cl * so, sl]])
    return np.asarray(enu, dtype=np.float64) @ R + o


def lla_to_enu(lat_deg, lon_deg, h, origin_lla):
    """GPS fixes in degrees -> local ENU meters around `origin_lla` — the
    LocalCartesian pipeline GPSFactor uses (navigation/GPSFactor.h:63). Feed
    the result to gps_residual as the 'measured' position."""
    return ecef_to_enu(lla_to_ecef(lat_deg, lon_deg, h), origin_lla)
