"""NavState: pose and velocity for inertial navigation, as [..., 3, 5].

JAX counterpart: gtsam_personal_tpu/navigation/navstate.py (all of it;
reference: gtsam/navigation/NavState.h). Storage [R | t | v]; the tangent is
(theta, dp, dv) with the reference's chart:

  retract(x, xi):  R' = R Exp(xi_R); t' = t + R xi_P; v' = v + R xi_V
                   (NavState::retract, NavState.cpp:309)
  local(x, y):     (Log(R^T R_y), R^T (t_y - t), R^T (v_y - v))
                   (NavState::localCoordinates, NavState.cpp:336)

The functions take any number of leading batch axes, and one element under
`torch.func.vmap`. NavState is not a registered manifold, as in the JAX
package: factor graphs store it as an (se3, vel3) pair of variables.
"""

import torch

from gtsam_personal_tpu_torch.geometry import so3

TANGENT_DIM = 9
PARAM_SHAPE = (3, 5)


def make(R, t, v):
    return torch.cat([R, t[..., None], v[..., None]], dim=-1)


def rotation(x):
    return x[..., :3]


def position(x):
    return x[..., 3]


def velocity(x):
    return x[..., 4]


def identity(*, device, dtype):
    return torch.eye(3, 5, device=device, dtype=dtype)


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


def retract(x, xi):
    R, t, v = rotation(x), position(x), velocity(x)
    return make(R @ so3.expmap(xi[..., :3]), t + _matvec(R, xi[..., 3:6]),
                v + _matvec(R, xi[..., 6:9]))


def local(x, y):
    R, t, v = rotation(x), position(x), velocity(x)
    Rt = R.transpose(-1, -2)
    return torch.cat([so3.logmap(Rt @ rotation(y)),
                      _matvec(Rt, position(y) - t),
                      _matvec(Rt, velocity(y) - v)], dim=-1)


def from_pose_vel(pose, vel):
    """From an SE(3) pose [..., 3, 4] and a velocity [..., 3]."""
    return torch.cat([pose, vel[..., None]], dim=-1)


def pose_of(x):
    return x[..., :4]
