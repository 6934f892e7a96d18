"""SO(3), SE(3) and SE(2) maps for the references, in plain torch.

Conventions of the reference library (GTSAM): a pose is camera- or
body-to-world; the retraction is the right one, p * Exp(xi); an SE(3)
tangent is (omega, v) and an SE(2) tangent is (vx, vy, omega), each with the
full exponential map.
"""

import torch


def tf32(x):
    """x rounded to TF32 (10 explicit mantissa bits, to nearest), as a
    tensor core rounds the operands of a float32 product with TF32 on."""
    bits = x.detach().float().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return r.to(x.dtype)


def einsum(eq, *ops, rnd=None):
    """torch.einsum with every operand passed through `rnd` first (None:
    as it is)."""
    if rnd is not None:
        ops = [rnd(o) for o in ops]
    return torch.einsum(eq, *ops)


def hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(w):
    """sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3 of t = |w|, by
    series below t^2 = 1e-8, each [..., 1, 1]. Scalars keep trailing axes:
    under vmap + jacfwd a 0-dim tensor that meets a Python number gets a
    float64 tangent."""
    t2 = (w * w).sum(-1, keepdim=True)[..., None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1 - t2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(t)) / t2s)
    c = torch.where(small, 1.0 / 6 - t2 / 120, (t - torch.sin(t)) / (t2s * t))
    return a, b, c


def so3_exp(w):
    """Rodrigues: I + a W + b W^2."""
    W = hat(w)
    a, b, _ = _coeffs(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * (W @ W)


def se3_retract(pose, xi):
    """pose [..., 3, 4] * Exp(xi), xi = (omega, v): R Exp(omega),
    t + R J_l(omega) v with J_l = I + b W + c W^2."""
    w, v = xi[..., :3], xi[..., 3:]
    W = hat(w)
    _, b, c = _coeffs(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    Jl = eye + b * W + c * (W @ W)
    R = pose[..., :3]
    Rn = R @ so3_exp(w)
    tn = pose[..., 3] + (R @ (Jl @ v[..., None]))[..., 0]
    return torch.cat([Rn, tn[..., None]], -1)


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _v_coeffs(w):
    """sin w / w and (1 - cos w) / w, by series below w^2 = 1e-10; w is
    [..., 1] (see _coeffs)."""
    w2 = w * w
    small = w2 < 1e-10
    ws = torch.where(small, torch.ones_like(w), w)
    return (torch.where(small, 1 - w2 / 6, torch.sin(ws) / ws),
            torch.where(small, 0.5 * w - w * w2 / 24, (1 - torch.cos(ws)) / ws))


def se2_compose(a, b):
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                        a[..., 1] + s * b[..., 0] + c * b[..., 1],
                        a[..., 2] + b[..., 2]], -1)


def se2_inverse(a):
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([-(c * a[..., 0] + s * a[..., 1]),
                        -(-s * a[..., 0] + c * a[..., 1]), -a[..., 2]], -1)


def se2_exp(xi):
    x, y, w = xi[..., 0:1], xi[..., 1:2], xi[..., 2:3]
    A, B = _v_coeffs(w)
    return torch.cat([A * x - B * y, B * x + A * y, w], -1)


def se2_log(p):
    x, y, w = p[..., 0:1], p[..., 1:2], wrap(p[..., 2:3])
    A, B = _v_coeffs(w)
    det = A * A + B * B
    return torch.cat([(A * x + B * y) / det, (-B * x + A * y) / det, w], -1)


def se2_retract(p, xi):
    return se2_compose(p, se2_exp(xi))
