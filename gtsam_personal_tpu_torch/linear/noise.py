"""Robust m-estimators: IRLS weight and loss.

JAX counterpart: gtsam_personal_tpu/linear/noise.py:robust_weight,
robust_loss (reference: linear/LossFunctions.h:66-555). These are all the
kinds that `robust=` of the BA engine can name; `k` is a float or a tensor
broadcastable against `e`.
"""

import torch


def robust_weight(kind: str, e, k):
    """IRLS weight w(e) with e = whitened residual norm >= 0."""
    ae = e.abs()
    if kind == "huber":
        return torch.where(ae <= k, torch.ones_like(e),
                           k / torch.clamp(ae, min=1e-12))
    if kind == "cauchy":
        return k * k / (k * k + e * e)
    if kind == "geman_mcclure":
        c2 = k * k
        return (c2 / (c2 + e * e)) ** 2
    if kind == "tukey":
        u = torch.clamp(1.0 - (e / k) ** 2, min=0.0)
        return u * u
    if kind == "welsch":
        return torch.exp(-(e / k) ** 2)
    if kind == "fair":
        return 1.0 / (1.0 + ae / k)
    if kind == "dcs":
        w = 2.0 * k / (k + e * e)
        return torch.where(e * e > k, torch.clamp(w * w, max=1.0),
                           torch.ones_like(e))
    if kind == "l2_with_dead_zone":
        d = torch.clamp(ae - k, min=0.0)
        return d / torch.clamp(ae, min=1e-12)
    if kind == "asymmetric_tukey":
        u = torch.clamp(1.0 - (e / k) ** 2, min=0.0)
        return torch.where(e >= 0, u * u, torch.ones_like(e))
    if kind == "asymmetric_cauchy":
        return torch.where(e >= 0, k * k / (k * k + e * e),
                           torch.ones_like(e))
    raise ValueError(f"unknown robust kind {kind!r}")


def robust_loss(kind: str, e, k):
    """rho(e) such that the total factor error is rho(||whitened r||)."""
    ae = e.abs()
    if kind == "huber":
        return torch.where(ae <= k, 0.5 * e * e, k * (ae - 0.5 * k))
    if kind == "cauchy":
        return 0.5 * k * k * torch.log1p((e / k) ** 2)
    if kind == "geman_mcclure":
        c2 = k * k
        return 0.5 * c2 * e * e / (c2 + e * e)
    if kind == "tukey":
        c2_6 = k * k / 6.0
        return c2_6 * (1.0 - torch.clamp(1.0 - (e / k) ** 2, min=0.0) ** 3)
    if kind == "welsch":
        return 0.5 * k * k * (1.0 - torch.exp(-(e / k) ** 2))
    if kind == "fair":
        return k * k * (ae / k - torch.log1p(ae / k))
    if kind == "dcs":
        return torch.where(e * e > k, k * e * e / (k + e * e), 0.5 * e * e)
    if kind == "l2_with_dead_zone":
        d = torch.clamp(ae - k, min=0.0)
        return 0.5 * d * d
    if kind in ("asymmetric_tukey", "asymmetric_cauchy"):
        base = robust_loss(kind.replace("asymmetric_", ""), e, k)
        return torch.where(e >= 0, base, 0.5 * e * e)
    raise ValueError(f"unknown robust kind {kind!r}")
