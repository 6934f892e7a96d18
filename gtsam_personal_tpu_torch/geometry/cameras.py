"""Calibration models and pinhole projection on batches.

JAX counterpart: gtsam_personal_tpu/geometry/cameras.py (all of it:
uncalibrate_cal3_s2, _cal3bundler, _cal3ds2, _cal3fisheye, _cal3unified,
nplane_to_space_cal3unified, UNCALIBRATE, CAL_DIMS, stereo_project,
project_point, depth_of; reference: Cal3_S2.h, Cal3Bundler.h, Cal3DS2.h,
Cal3Fisheye.h, Cal3Unified.h, PinholeCamera.h). Every model is a function of
a flat parameter vector k [..., n] and a normalized point p [..., 2], so a
calibration is a vector-space variable like any other:

  cal3_s2:      [fx, fy, s, u0, v0]                       (dim 5)
  cal3bundler:  [f, k1, k2]                               (dim 3)
  cal3ds2:      [fx, fy, s, u0, v0, k1, k2, p1, p2]       (dim 9)
  cal3fisheye:  [fx, fy, s, u0, v0, k1, k2, k3, k4]       (dim 9)
  cal3unified:  cal3ds2's nine and the mirror xi          (dim 10)

The functions take any number of leading batch axes, and one element under
`torch.func.vmap`.
"""

import torch

from gtsam_personal_tpu_torch.geometry import se3


def _pinhole(k, xd, yd):
    """(fx xd + s yd + u0, fy yd + v0) for k = [fx, fy, s, u0, v0, ...]."""
    return torch.stack([k[..., 0] * xd + k[..., 2] * yd + k[..., 3],
                        k[..., 1] * yd + k[..., 4]], dim=-1)


def uncalibrate_cal3_s2(k, p):
    """Normalized image point -> pixels (reference: Cal3_S2::uncalibrate)."""
    return _pinhole(k, p[..., 0], p[..., 1])


def uncalibrate_cal3bundler(k, p):
    """k [..., 3] = (f, k1, k2), normalized point p [..., 2] -> pixels:
    f (1 + k1 r2 + k2 r2^2) p, no principal point (reference:
    Cal3Bundler::uncalibrate)."""
    f, k1, k2 = k.unbind(-1)
    r2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
    g = f * (1.0 + k1 * r2 + k2 * r2 * r2)
    return g[..., None] * p


def uncalibrate_cal3ds2(k, p):
    """Radial-tangential distortion (reference:
    Cal3DS2_Base::uncalibrate)."""
    k1, k2, p1, p2 = k[..., 5], k[..., 6], k[..., 7], k[..., 8]
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return _pinhole(k, g * x + dx, g * y + dy)


def uncalibrate_cal3fisheye(k, p):
    """Equidistant fisheye (reference: Cal3Fisheye::uncalibrate)."""
    k1, k2, k3, k4 = k[..., 5], k[..., 6], k[..., 7], k[..., 8]
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    r = torch.sqrt(r2 + 1e-30)
    th = torch.atan(r)
    th2 = th * th
    thd = th * (1.0 + k1 * th2 + k2 * th2 ** 2 + k3 * th2 ** 3
                + k4 * th2 ** 4)
    scale = torch.where(r2 < 1e-20, torch.ones_like(r), thd / r)
    return _pinhole(k, scale * x, scale * y)


def uncalibrate_cal3unified(k, p):
    """Unified (catadioptric) model: p / (1 + xi sqrt(x^2 + y^2 + 1)), then
    Cal3DS2 (reference: Cal3Unified::uncalibrate, Cal3Unified.h:38)."""
    xi = k[..., 9:10]
    den = 1.0 + xi * torch.sqrt(p[..., 0:1] * p[..., 0:1]
                                + p[..., 1:2] * p[..., 1:2] + 1.0)
    return uncalibrate_cal3ds2(k[..., :9], p / den)


def nplane_to_space_cal3unified(k, pn):
    """Inverse of the unified model's sphere mapping (reference:
    Cal3Unified::nPlaneToSpace): lift to the unit sphere with
    f = (xi + sqrt(1 + (1 - xi^2) r^2)) / (1 + r^2), divide by f - xi."""
    xi = k[..., 9:10]
    r2 = pn[..., 0:1] * pn[..., 0:1] + pn[..., 1:2] * pn[..., 1:2]
    f = (xi + torch.sqrt(torch.maximum(1.0 + (1.0 - xi * xi) * r2,
                                       torch.zeros_like(r2)))) / (1.0 + r2)
    return pn * f / torch.maximum(f - xi, torch.full_like(f, 1e-12))


UNCALIBRATE = {
    "cal3_s2": uncalibrate_cal3_s2,
    "cal3bundler": uncalibrate_cal3bundler,
    "cal3ds2": uncalibrate_cal3ds2,
    "cal3fisheye": uncalibrate_cal3fisheye,
    "cal3unified": uncalibrate_cal3unified,
}

CAL_DIMS = {"cal3_s2": 5, "cal3bundler": 3, "cal3ds2": 9, "cal3fisheye": 9,
            "cal3unified": 10, "cal3_s2stereo": 6}


def _safe_depth(z, eps):
    e = torch.full_like(z, eps)
    return torch.where(z.abs() < eps, torch.where(z < 0, -e, e), z)


def stereo_project(k, pc):
    """Cal3_S2Stereo projection of a camera-frame point [..., 3] to
    (uL, uR, v), k = [fx, fy, s, u0, v0, b] (reference: Cal3_S2Stereo.h,
    StereoCamera::project). A depth below 1e-8 in magnitude is taken as
    +1e-8, as the JAX package does."""
    fx, fy, s, u0, v0, b = k.unbind(-1)
    z = pc[..., 2]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    x, y = pc[..., 0] / z_safe, pc[..., 1] / z_safe
    return torch.stack([fx * x + s * y + u0,
                        fx * (pc[..., 0] - b) / z_safe + s * y + u0,
                        fy * y + v0], dim=-1)


def project_point(pose, point, cal_params, cal_model: str = "cal3_s2",
                  eps: float = 1e-8):
    """World point -> pixels through the calibration `cal_model` for
    camera-to-world poses [..., 3, 4]. Depth is clamped to +-eps away from
    zero (the reference throws CheiralityException; the BA engine masks
    those rows instead)."""
    pc = se3.transform_to(pose, point)
    z_safe = _safe_depth(pc[..., 2], eps)
    pn = torch.stack([pc[..., 0] / z_safe, pc[..., 1] / z_safe], dim=-1)
    return UNCALIBRATE[cal_model](cal_params, pn)


def depth_of(pose, point):
    """Camera-frame depth (positive = in front of the camera)."""
    return se3.transform_to(pose, point)[..., 2]
