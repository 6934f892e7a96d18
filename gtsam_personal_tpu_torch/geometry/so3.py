"""SO(3) on batches of rotation matrices.

JAX counterpart: gtsam_personal_tpu/geometry/so3.py:hat, vee, identity,
_trig_coeffs, expmap, logmap, compose, inverse, between, rotate, unrotate,
retract, local, left_jacobian, left_jacobian_inverse, adjoint, normalize. The JAX functions act
on one element and are batched with `jax.vmap`; these take any number of
leading batch axes, and one element under `torch.func.vmap`.

Tangent convention: axis-angle omega, R = exp(hat(omega)) (reference:
Rot3::Expmap). The small-angle branches keep the Taylor guards of the JAX
package, so no 0/0 is ever evaluated in the selected branch.

Scalar quantities (squared angle, trace, the series coefficients) keep a
trailing axis of size 1. Under `vmap` + `jacfwd` a 0-dim tensor that meets a
Python number (`theta2 / 6.0`) gets a float64 tangent whatever its dtype,
and the next matrix product then refuses the mixed dtypes; a [..., 1] tensor
does not.
"""

import torch

TANGENT_DIM = 3
PARAM_SHAPE = (3, 3)

_SMALL = 1e-6  # squared-angle threshold for Taylor branches


def hat(w):
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W):
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def identity(*, device, dtype):
    return torch.eye(3, device=device, dtype=dtype)


def _trig_coeffs(theta2):
    """A = sin(t)/t, B = (1-cos t)/t^2, C = (t - sin t)/t^3, Taylor-guarded
    below theta^2 = 1e-6 (reference: SO3.h DexpFunctor)."""
    small = theta2 < _SMALL
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2)
    A = torch.where(small, 1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                    torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
                    (1.0 - torch.cos(theta)) / t2)
    C = torch.where(small,
                    1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                    (theta - torch.sin(theta)) / (t2 * theta))
    return A, B, C


def _theta2(w):
    """Squared angle [..., 1] of axis-angle vectors [..., 3]."""
    return (w * w).sum(-1, keepdim=True)


def _eye_plus(w, a, b):
    """I + a W + b W^2 with W = hat(w), a and b of shape [..., 1]."""
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None] * W + b[..., None] * (W @ W)


def expmap(w):
    """Rodrigues: [..., 3] -> [..., 3, 3], R = I + A W + B W^2."""
    A, B, _ = _trig_coeffs(_theta2(w))
    return _eye_plus(w, A, B)


def left_jacobian(w):
    """SO(3) left Jacobian J_l = I + B W + C W^2, [..., 3] -> [..., 3, 3]."""
    _, B, C = _trig_coeffs(_theta2(w))
    return _eye_plus(w, B, C)


def left_jacobian_inverse(w):
    """Inverse left Jacobian I - W/2 + D W^2 with
    D = 1/t^2 - (1 + cos t) / (2 t sin t), Taylor-guarded."""
    theta2 = _theta2(w)
    small = theta2 < _SMALL
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2)
    s = torch.sin(theta)
    s_safe = torch.where(s.abs() < 1e-12, torch.ones_like(s), s)
    exact = 1.0 / t2 - (1.0 + torch.cos(theta)) / (2.0 * theta * s_safe)
    taylor = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    return _eye_plus(w, torch.full_like(theta2, -0.5),
                     torch.where(small, taylor, exact))


def logmap(R):
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3], with the
    branches of the JAX package (reference: Rot3::Logmap, SO3.cpp): the
    generic atan2 formula, a polynomial near zero, and the axis taken from
    the largest diagonal entry near pi.

    Every intermediate of a branch is guarded so that it stays finite where
    that branch is not the one selected."""
    Rt = R.transpose(-1, -2)
    v = 0.5 * vee(R - Rt)                         # sin(theta) * axis
    s2 = _theta2(v)                               # sin(theta)^2, [..., 1]
    diag = R.diagonal(dim1=-2, dim2=-1)
    c = 0.5 * (diag.sum(-1, keepdim=True) - 1.0)  # cos(theta), [..., 1]
    s_small = s2 < 1e-12

    s_safe = torch.sqrt(torch.where(s_small, torch.ones_like(s2), s2))
    generic = (torch.atan2(s_safe, c) / s_safe) * v

    # near zero (s small, c > 0): theta / sin(theta) as a polynomial in s^2
    near_zero = (1.0 + s2 / 6.0 + 7.0 * s2 * s2 / 360.0) * v

    # near pi (s small, c < 0): R ~ 2 a a^T - I; the axis comes from the
    # column of the largest diagonal entry, its sign from v
    theta_pi = torch.atan2(torch.sqrt(s2 + 1e-30), c)
    dmax = diag.max(-1, keepdim=True)
    onehot = torch.arange(3, device=R.device) == dmax.indices    # [..., 3]
    dk = torch.clamp(dmax.values, min=-1.0 + 1e-12)
    ak = torch.sqrt((dk + 1.0) * 0.5)
    ak_safe = torch.where(ak < 1e-12, torch.ones_like(ak), ak)
    sel = onehot.to(R.dtype)
    col_k = (R * sel[..., None, :]).sum(-1)       # R[:, k]
    row_k = (R * sel[..., :, None]).sum(-2)       # R[k, :]
    col = 0.25 * (col_k + row_k) / ak_safe
    a = torch.where(onehot, ak, col)
    a = a / torch.sqrt(torch.clamp(_theta2(a), min=1e-24))
    sign = torch.where((a * v).sum(-1, keepdim=True) < 0.0,
                       -torch.ones_like(c), torch.ones_like(c))
    near_pi = theta_pi * sign * a

    return torch.where(s_small, torch.where(c > 0.0, near_zero, near_pi),
                       generic)


def compose(R1, R2):
    return R1 @ R2


def inverse(R):
    return R.transpose(-1, -2)


def between(R1, R2):
    """R1^{-1} R2 (reference: LieGroup::between)."""
    return R1.transpose(-1, -2) @ R2


def rotate(R, p):
    return (R @ p[..., None])[..., 0]


def unrotate(R, p):
    return (R.transpose(-1, -2) @ p[..., None])[..., 0]


def retract(R, w):
    """Right retraction R * Exp(w), the reference's default Rot3 chart."""
    return R @ expmap(w)


def local(R1, R2):
    """Inverse retraction Log(R1^T R2)."""
    return logmap(between(R1, R2))


def adjoint(R):
    """The adjoint map of SO(3) is R itself."""
    return R


def normalize(R):
    """Project near-rotations [..., 3, 3] onto SO(3) by SVD (reference:
    Rot3::ClosestTo): U diag(1, 1, d) V^T with d = det(U V^T), the
    determinant itself as the JAX package takes it, not its sign."""
    U, _, Vh = torch.linalg.svd(R)
    d = torch.linalg.det(U @ Vh)
    return (U * torch.stack([torch.ones_like(d), torch.ones_like(d), d],
                            dim=-1)[..., None, :]) @ Vh
