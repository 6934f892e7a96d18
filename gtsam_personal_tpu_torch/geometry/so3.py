"""SO(3) on batches of rotation matrices.

JAX counterpart: gtsam_personal_tpu/geometry/so3.py:hat, _trig_coeffs,
expmap, left_jacobian. The JAX functions act on one element and are batched
with `jax.vmap`; these take any number of leading batch axes.

Tangent convention: axis-angle omega, R = exp(hat(omega)) (reference:
Rot3::Expmap). The small-angle branches keep the Taylor guards of the JAX
package, so no 0/0 is ever evaluated in the selected branch.
"""

import torch

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


def _eye_plus(w, a, b):
    """I + a W + b W^2 with W = hat(w), a and b of shape [...]."""
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def expmap(w):
    """Rodrigues: [..., 3] -> [..., 3, 3], R = I + A W + B W^2."""
    A, B, _ = _trig_coeffs((w * w).sum(-1))
    return _eye_plus(w, A, B)


def left_jacobian(w):
    """SO(3) left Jacobian J_l = I + B W + C W^2, [..., 3] -> [..., 3, 3]."""
    _, B, C = _trig_coeffs((w * w).sum(-1))
    return _eye_plus(w, B, C)
