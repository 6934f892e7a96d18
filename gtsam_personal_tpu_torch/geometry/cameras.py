"""Cal3Bundler pinhole projection on batches.

JAX counterpart: gtsam_personal_tpu/geometry/cameras.py:
uncalibrate_cal3bundler, project_point, depth_of. Only the Cal3Bundler model
is ported: it is the one the bundle-adjustment main path uses.
"""

import torch

from gtsam_personal_tpu_torch.geometry import se3


def uncalibrate_cal3bundler(k, p):
    """k [..., 3] = (f, k1, k2), normalized point p [..., 2] -> pixels:
    f (1 + k1 r2 + k2 r2^2) p (reference: Cal3Bundler::uncalibrate)."""
    f, k1, k2 = k.unbind(-1)
    r2 = p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1]
    g = f * (1.0 + k1 * r2 + k2 * r2 * r2)
    return g[..., None] * p


def project_point(pose, point, cal_params, eps: float = 1e-8):
    """World point -> Cal3Bundler pixels for camera-to-world poses
    [..., 3, 4]. Depth is clamped to +-eps away from zero (the reference
    throws CheiralityException; the BA engine masks those rows instead)."""
    pc = se3.transform_to(pose, point)
    z = pc[..., 2]
    e = torch.full_like(z, eps)
    z_safe = torch.where(z.abs() < eps, torch.where(z < 0, -e, e), z)
    pn = torch.stack([pc[..., 0] / z_safe, pc[..., 1] / z_safe], dim=-1)
    return uncalibrate_cal3bundler(cal_params, pn)


def depth_of(pose, point):
    """Camera-frame depth (positive = in front of the camera)."""
    return se3.transform_to(pose, point)[..., 2]
