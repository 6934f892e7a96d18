"""SE(2) on batches of planar rigid transforms stored as [..., 3] = (x, y,
theta).

JAX counterpart: gtsam_personal_tpu/geometry/se2.py (all of it; reference:
gtsam/geometry/Pose2.h). Tangent xi = (v_x, v_y, omega) with the full
exponential map as the chart (Pose2::Expmap); `retract` is the right
retraction p * Exp(xi). The functions take any number of leading batch axes,
and one element under `torch.func.vmap`.

The small-angle branches divide by `w_safe`, which is 1 wherever the Taylor
branch is the one selected, so neither side of a `torch.where` ever holds a
NaN that forward-mode differentiation could carry into the result. The
angle goes through them as a [..., 1] slice, not as a 0-dim element: see
geometry/so3.py on the tangents of 0-dim tensors.
"""

import torch

from gtsam_personal_tpu_torch.geometry import so2

TANGENT_DIM = 3
PARAM_SHAPE = (3,)

_SMALL = 1e-10


def identity(*, device, dtype):
    return torch.zeros(3, device=device, dtype=dtype)


def translation(p):
    return p[..., :2]


def rotation(p):
    return p[..., 2]


def make(t, theta):
    return torch.cat([t, theta[..., None]], dim=-1)


def _v_coeffs(w):
    """A = sin w / w and B = (1 - cos w) / w of the SE(2) V-matrix
    [[A, -B], [B, A]], Taylor-guarded below w^2 = 1e-10; w is [..., 1]."""
    w2 = w * w
    small = w2 < _SMALL
    w_safe = torch.where(small, torch.ones_like(w), w)
    A = torch.where(small, 1.0 - w2 / 6.0, torch.sin(w_safe) / w_safe)
    B = torch.where(small, 0.5 * w - w * w2 / 24.0,
                    (1.0 - torch.cos(w_safe)) / w_safe)
    return A, B


def expmap(xi):
    """xi = (vx, vy, w) -> pose; t = V(w) v."""
    vx, vy, w = xi[..., 0:1], xi[..., 1:2], xi[..., 2:3]
    A, B = _v_coeffs(w)
    return torch.cat([A * vx - B * vy, B * vx + A * vy, w], dim=-1)


def logmap(p):
    """Inverse of expmap; (vx, vy, w) with w wrapped to (-pi, pi]."""
    tx, ty, w = p[..., 0:1], p[..., 1:2], so2.wrap(p[..., 2:3])
    A, B = _v_coeffs(w)
    det = A * A + B * B
    # V^{-1} = 1/det * [[A, B], [-B, A]]
    return torch.cat([(A * tx + B * ty) / det, (-B * tx + A * ty) / det, w],
                     dim=-1)


def compose(a, b):
    return make(a[..., :2] + so2.rotate(a[..., 2], b[..., :2]),
                a[..., 2] + b[..., 2])


def inverse(a):
    return make(-so2.unrotate(a[..., 2], a[..., :2]), -a[..., 2])


def between(a, b):
    return compose(inverse(a), b)


def transform_from(p, pt):
    """Apply the pose to a point of its local frame
    (Pose2::transformFrom)."""
    return p[..., :2] + so2.rotate(p[..., 2], pt)


def transform_to(p, pt):
    """World point -> local frame (Pose2::transformTo)."""
    return so2.unrotate(p[..., 2], pt - p[..., :2])


def retract(p, xi):
    """Right retraction p * Exp(xi), the reference's default Pose2 chart."""
    return compose(p, expmap(xi))


def local(a, b):
    return logmap(between(a, b))


def adjoint(p):
    """AdjointMap [..., 3, 3] in (v, w) tangent ordering
    (Pose2::AdjointMap)."""
    x, y = p[..., 0], p[..., 1]
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    z, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, y], dim=-1),
                        torch.stack([s, c, -x], dim=-1),
                        torch.stack([z, z, one], dim=-1)], dim=-2)


def bearing(p, pt):
    """Bearing angle to a 2D point (Pose2::bearing)."""
    d = transform_to(p, pt)
    return torch.atan2(d[..., 1], d[..., 0])


def range_to(p, pt):
    d = pt - p[..., :2]
    return torch.sqrt((d * d).sum(-1))
