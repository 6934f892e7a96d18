"""SO(2) on batches of planar rotations stored as one angle.

JAX counterpart: gtsam_personal_tpu/geometry/so2.py (all of it; reference:
gtsam/geometry/Rot2.h). The JAX functions act on one element and are batched
with `jax.vmap`; these take any number of leading batch axes, and one
element under `torch.func.vmap`. An angle has shape [...]; a tangent has
shape [..., 1]; compose is addition, wrapped only by `logmap` and `local`.
"""

import torch

TANGENT_DIM = 1
PARAM_SHAPE = ()


def wrap(theta):
    """Wrap an angle to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def identity(*, device, dtype):
    return torch.zeros((), device=device, dtype=dtype)


def expmap(w):
    """Tangent [..., 1] (or a bare angle of no axis) -> angle [...]."""
    return w if w.ndim == 0 else w[..., 0]


def logmap(theta):
    return wrap(theta)[..., None]


def compose(a, b):
    return a + b


def inverse(a):
    return -a


def between(a, b):
    return b - a


def matrix(theta):
    """[...] -> rotation matrices [..., 2, 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


def rotate(theta, p):
    """R(theta) p for p [..., 2], written out: no batched matrix product."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = p[..., 0], p[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def unrotate(theta, p):
    """R(theta)^T p for p [..., 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = p[..., 0], p[..., 1]
    return torch.stack([c * x + s * y, c * y - s * x], dim=-1)


def retract(theta, w):
    return theta + expmap(w)


def local(a, b):
    return wrap(b - a)[..., None]
