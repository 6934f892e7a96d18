"""SE(3) on batches of rigid transforms stored as [..., 3, 4] = [R | t].

JAX counterpart: gtsam_personal_tpu/geometry/se3.py:identity, make, rotation,
translation, expmap, logmap, compose, inverse, between, transform_from,
transform_to, retract, local, adjoint, range_to. Tangent xi = (omega, v), rotation first (reference:
Pose3.h:147-150); `retract` is the right retraction p * Exp(xi). The
functions take any number of leading batch axes, and one element under
`torch.func.vmap`.
"""

import torch

from gtsam_personal_tpu_torch.geometry import so3


TANGENT_DIM = 6
PARAM_SHAPE = (3, 4)


def identity(*, device, dtype):
    return torch.eye(3, 4, device=device, dtype=dtype)


def make(R, t):
    return torch.cat([R, t[..., None]], dim=-1)


def rotation(p):
    return p[..., :3]


def translation(p):
    return p[..., 3]


def _matvec(A, x):
    """[..., 3, 3] @ [..., 3] -> [..., 3]."""
    return (A @ x[..., None])[..., 0]


def expmap(xi):
    """[..., 6] -> [..., 3, 4]: R = Exp(omega), t = J_l(omega) v."""
    w, v = xi[..., :3], xi[..., 3:]
    return make(so3.expmap(w), _matvec(so3.left_jacobian(w), v))


def logmap(p):
    w = so3.logmap(p[..., :3])
    return torch.cat([w, _matvec(so3.left_jacobian_inverse(w), p[..., 3])],
                     dim=-1)


def compose(a, b):
    Ra, ta = a[..., :3], a[..., 3]
    Rb, tb = b[..., :3], b[..., 3]
    return make(Ra @ Rb, ta + _matvec(Ra, tb))


def inverse(a):
    Rt = a[..., :3].transpose(-1, -2)
    return make(Rt, -_matvec(Rt, a[..., 3]))


def between(a, b):
    return compose(inverse(a), b)


def transform_from(p, pt):
    """Point [..., 3] of the pose's frame into the world: R pt + t."""
    return _matvec(p[..., :3], pt) + p[..., 3]


def transform_to(p, pt):
    """World point [..., 3] into the frame of pose p: R^T (pt - t).

    Written as an elementwise product and a sum over the three rows, not as
    a batched matrix product: it runs once per observation on the error
    path, where [M, 3, 3] @ [M, 3, 1] would go through a batched GEMM."""
    return (p[..., :3] * (pt - p[..., 3])[..., :, None]).sum(-2)


def retract(p, xi):
    """Right retraction p * Exp(xi) (reference default chart)."""
    return compose(p, expmap(xi))


def local(a, b):
    return logmap(between(a, b))


def adjoint(p):
    """AdjointMap [..., 6, 6] in (omega, v) ordering (reference:
    Pose3::AdjointMap, Pose3.h:156)."""
    R = p[..., :3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([so3.hat(p[..., 3]) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def range_to(p, pt):
    d = pt - p[..., 3]
    return torch.sqrt((d * d).sum(-1))
