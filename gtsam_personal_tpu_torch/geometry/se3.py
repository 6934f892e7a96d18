"""SE(3) on batches of rigid transforms stored as [..., 3, 4] = [R | t].

JAX counterpart: gtsam_personal_tpu/geometry/se3.py:expmap, compose,
transform_to, retract. Tangent xi = (omega, v), rotation first (reference:
Pose3.h:147-150); `retract` is the right retraction p * Exp(xi).
"""

import torch

from gtsam_personal_tpu_torch.geometry import so3


def _make(R, t):
    return torch.cat([R, t[..., None]], dim=-1)


def _matvec(A, x):
    """[..., 3, 3] @ [..., 3] -> [..., 3]."""
    return (A @ x[..., None])[..., 0]


def expmap(xi):
    """[..., 6] -> [..., 3, 4]: R = Exp(omega), t = J_l(omega) v."""
    w, v = xi[..., :3], xi[..., 3:]
    return _make(so3.expmap(w), _matvec(so3.left_jacobian(w), v))


def compose(a, b):
    Ra, ta = a[..., :3], a[..., 3]
    Rb, tb = b[..., :3], b[..., 3]
    return _make(Ra @ Rb, ta + _matvec(Ra, tb))


def transform_to(p, pt):
    """World point [..., 3] into the frame of pose p: R^T (pt - t).

    Written as an elementwise product and a sum over the three rows, not as
    a batched matrix product: it runs once per observation on the error
    path, where [M, 3, 3] @ [M, 3, 1] would go through a batched GEMM."""
    return (p[..., :3] * (pt - p[..., 3])[..., :, None]).sum(-2)


def retract(p, xi):
    """Right retraction p * Exp(xi) (reference default chart)."""
    return compose(p, expmap(xi))
