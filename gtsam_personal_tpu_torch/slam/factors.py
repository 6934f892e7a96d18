"""SLAM measurement factors: priors, between factors, bearing/range and
landmark observations.

JAX counterpart: gtsam_personal_tpu/slam/factors.py:make_prior_residual,
make_between_residual, bearing_range_2d_residual, range_2d_residual,
pose_point_2d_residual, pose_point_3d_residual, add_prior, add_between,
diag_noise, full_info_noise (lines 22-109; reference:
gtsam/slam/BetweenFactor.h, nonlinear/PriorFactor.h,
sam/BearingRangeFactor.h). Each factor type is a pure residual function over
ONE factor's manifold points; the Jacobians come from forward-mode
differentiation through the retraction (linear/linearize.py).

Residual conventions match the reference, so costs are comparable:
- prior:    r = Local(prior, x)                      (PriorFactor)
- between:  r = Local(measured, between(x1, x2))     (BetweenFactor)
"""

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import se2, se3, so2, so3

_BETWEEN = {"se2": se2.between, "se3": se3.between, "so3": so3.between,
            "so2": so2.between}


def make_prior_residual(group: str):
    m = manifolds.get(group)

    def residual(xs, meas):
        (x,) = xs
        return m.local(meas["prior"], x)

    residual.__name__ = f"prior_{group}"
    return residual


def make_between_residual(group: str):
    m = manifolds.get(group)
    between = _BETWEEN.get(group, lambda a, b: b - a)   # else a vector space

    def residual(xs, meas):
        x1, x2 = xs
        return m.local(meas["measured"], between(x1, x2))

    residual.__name__ = f"between_{group}"
    return residual


def bearing_range_2d_residual(xs, meas):
    """Pose2 -> Point2 bearing and range (reference: BearingRangeFactor with
    A1 = Pose2, A2 = Point2): [wrapped bearing error, range error]."""
    pose, point = xs
    db = so2.wrap(se2.bearing(pose, point) - meas["bearing"])
    return torch.stack([db, se2.range_to(pose, point) - meas["range"]])


def range_2d_residual(xs, meas):
    pose, point = xs
    return (se2.range_to(pose, point) - meas["range"]).reshape(1)


def pose_point_2d_residual(xs, meas):
    """Observation of a landmark in the pose frame (simulated2D style)."""
    pose, point = xs
    return se2.transform_to(pose, point) - meas["measured"]


def pose_point_3d_residual(xs, meas):
    pose, point = xs
    return se3.transform_to(pose, point) - meas["measured"]


_NAMED = {"bearing_range_2d": bearing_range_2d_residual,
          "range_2d": range_2d_residual,
          "pose_point_2d": pose_point_2d_residual,
          "pose_point_3d": pose_point_3d_residual}


def residual_by_name(name: str):
    """The residual function of a batch named `prior_<group>`,
    `between_<group>`, or one of `bearing_range_2d`, `range_2d`,
    `pose_point_2d`, `pose_point_3d` (an `_anti` suffix, which
    `FactorBatch.negated` adds, is ignored)."""
    while name.endswith("_anti"):
        name = name[:-len("_anti")]
    if name in _NAMED:
        return _NAMED[name]
    kind, _, group = name.partition("_")
    makers = {"prior": make_prior_residual, "between": make_between_residual}
    if kind not in makers or not group:
        raise ValueError(f"no residual function is known for a batch named "
                         f"{name!r} (known: prior_<group>, between_<group>, "
                         f"{', '.join(sorted(_NAMED))})")
    return makers[kind](group)


# -- sugar for adding factors to a GraphBuilder -------------------------------

def add_prior(gb, group, i, prior, noise_dict):
    gb.add(f"prior_{group}", make_prior_residual(group), (group,),
           manifolds.get(group).dim, [i], {"prior": prior}, noise_dict)


def add_between(gb, group, i, j, measured, noise_dict):
    gb.add(f"between_{group}", make_between_residual(group), (group, group),
           manifolds.get(group).dim, [i, j], {"measured": measured},
           noise_dict)


def diag_noise(sigmas_arr):
    s = np.asarray(sigmas_arr, dtype=np.float64)
    w = np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 1e3)
    return {"kind": "diag", "data": w}


def full_info_noise(info):
    """Full information matrix -> sqrt-information upper factor (host)."""
    info = np.asarray(info, dtype=np.float64)
    info = 0.5 * (info + info.T)
    w, V = np.linalg.eigh(info)          # numerical PSD safety
    w = np.clip(w, 0.0, None)
    L = np.linalg.cholesky(V @ np.diag(w) @ V.T
                           + 1e-12 * np.eye(info.shape[0]))
    return {"kind": "full", "data": L.T}
