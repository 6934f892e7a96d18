"""Noise models and robust m-estimator losses, batched.

JAX counterpart: gtsam_personal_tpu/linear/noise.py (all of it; reference:
gtsam/linear/NoiseModel.h and linear/LossFunctions.h:66-555). A noise model
carries per-factor-batch tensors with leading dimension K (or none, when the
batch shares one model); whitening is one batched product.

Hard constraints (the reference's `Constrained` model with sigma = 0) are
large-weight penalties, as in the JAX package.
"""

from typing import Optional

import numpy as np
import torch

CONSTRAINED_PENALTY_WEIGHT = 1e6  # squared-info weight put for sigma == 0


class NoiseModel:
    """kind: 'unit' | 'diag' (data = sqrt-info diagonal [K?, r]) | 'full'
    (data = sqrt-information matrix S with S^T S = Sigma^{-1}, [K?, r, r]) |
    'constrained' (data = sigmas [K?, r] where sigma == 0 marks a hard
    constraint; `k` holds the mu penalty weight, reference default 1000,
    linear/NoiseModel.h:301).

    robust: 'none' or an m-estimator name; k is its tuning constant.
    For 'constrained', whiten_residual() passes constrained rows through
    raw, error() weights them by mu, and whiten_system() scales them by
    sqrt(mu), so every solver sees the penalty form."""

    def __init__(self, kind: str, data: Optional[torch.Tensor] = None,
                 robust: str = "none", k: Optional[torch.Tensor] = None):
        self.kind = kind
        self.data = data
        self.robust = robust
        self.k = k

    def with_robust(self, robust: str, k) -> "NoiseModel":
        if self.data is not None:
            k = torch.as_tensor(k, dtype=self.data.dtype,
                                device=self.data.device)
        return NoiseModel(self.kind, self.data, robust, k)

    def __repr__(self):
        return f"NoiseModel({self.kind}, robust={self.robust})"


# -- factories (reference: NoiseModel::Sigmas/Variances/Covariance/Isotropic) -

def _t(x, device, dtype):
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x, dtype=dtype, device=device)


def unit() -> NoiseModel:
    return NoiseModel("unit")


def sigmas(s, *, device, dtype) -> NoiseModel:
    """Diagonal model from standard deviations; sigma == 0 entries become
    hard constraints through a large penalty weight."""
    s = _t(s, device, dtype)
    pos = s > 0
    w = torch.where(pos, 1.0 / torch.where(pos, s, torch.ones_like(s)),
                    torch.full_like(s, CONSTRAINED_PENALTY_WEIGHT ** 0.5))
    return NoiseModel("diag", w)


def precisions(p, *, device, dtype) -> NoiseModel:
    return NoiseModel("diag", torch.sqrt(_t(p, device, dtype)))


def isotropic(dim: int, sigma: float, *, device, dtype) -> NoiseModel:
    return sigmas(np.full((dim,), sigma), device=device, dtype=dtype)


def information(info, *, device, dtype) -> NoiseModel:
    """Full Gaussian model from the information matrix: S = chol(info)^T,
    upper triangular with S^T S = info; batched over leading axes."""
    info = _t(info, device, dtype)
    L = torch.linalg.cholesky(0.5 * (info + info.transpose(-1, -2)))
    return NoiseModel("full", L.transpose(-1, -2))


def covariance(cov, *, device, dtype) -> NoiseModel:
    """Full Gaussian model from the covariance matrix."""
    return information(torch.linalg.inv(_t(cov, device, dtype)),
                       device=device, dtype=dtype)


def sqrt_information(S, *, device, dtype) -> NoiseModel:
    return NoiseModel("full", _t(S, device, dtype))


def robust(base: NoiseModel, kind: str, k) -> NoiseModel:
    return base.with_robust(kind, k)


def constrained_sigmas(s, mu: float = 1000.0, *, device,
                       dtype) -> NoiseModel:
    """Mixed hard/soft model: sigma == 0 rows are hard constraints
    (reference: Constrained::MixedSigmas, linear/NoiseModel.h:301)."""
    return NoiseModel("constrained", _t(s, device, dtype), "none",
                      _t(mu, device, dtype))


def constrained_all(dim: int, mu: float = 1000.0, *, device,
                    dtype) -> NoiseModel:
    """All-rows-constrained model (reference: Constrained::All)."""
    return constrained_sigmas(np.zeros(dim), mu, device=device, dtype=dtype)


def _constrained_weights(sig):
    """Finite-row whitening weights; constrained rows pass through raw."""
    pos = sig > 0
    one = torch.ones_like(sig)
    return torch.where(pos, 1.0 / torch.where(pos, sig, one), one)


# -- whitening ---------------------------------------------------------------

def whiten_residual(noise: NoiseModel, r):
    """r: [K, rdim] -> whitened residual (no robust weighting)."""
    if noise.kind == "unit":
        return r
    if noise.kind == "diag":
        return r * noise.data
    if noise.kind == "constrained":
        return r * _constrained_weights(noise.data)
    return (noise.data @ r[..., None])[..., 0]        # full: S r, batched


def whiten_system(noise: NoiseModel, r, Js):
    """Whiten the residual [K, rdim] and the Jacobian blocks (tuple of
    [K, rdim, d_s]), then apply the sqrt IRLS weights of a robust model.

    Reference: NoiseModel::WhitenSystem (linear/NoiseModel.h:88-113) and
    Robust::WhitenSystem."""
    rw = whiten_residual(noise, r)
    if noise.kind == "unit":
        Jw = tuple(Js)
    elif noise.kind == "diag":
        Jw = tuple(J * noise.data[..., None] for J in Js)
    elif noise.kind == "constrained":
        # penalty form: constrained rows get sqrt(mu)
        w = _constrained_weights(noise.data)
        sm = torch.where(noise.data > 0, torch.ones_like(noise.data),
                         torch.sqrt(noise.k))
        rw = rw * sm
        Jw = tuple(J * (w * sm)[..., None] for J in Js)
    else:
        Jw = tuple(noise.data @ J for J in Js)
    if noise.robust != "none":
        e = torch.sqrt((rw * rw).sum(-1))
        sw = torch.sqrt(robust_weight(noise.robust, e, noise.k))
        rw = rw * sw[..., None]
        Jw = tuple(J * sw[..., None, None] for J in Jw)
    return rw, Jw


def log_det_whitener(noise: NoiseModel) -> float:
    """Host-side log|det W| of the whitening matrix W (r_w = W r), summed
    over the batch if the noise data is per-factor.

    The Gaussian negative log-likelihood is
      0.5 ||W r||^2 - log|det W| + (rdim/2) log 2pi,
    so -log|det W| is what tells apart hypotheses whose noise models differ
    (reference: HybridGaussianFactor's logNormalizers)."""
    if noise.kind == "unit":
        return 0.0
    data = noise.data.detach().cpu().numpy()
    if noise.kind == "diag":
        return float(np.sum(np.log(data)))
    if noise.kind == "constrained":
        mu = float(noise.k) if noise.k is not None else 1000.0
        w = np.where(data > 0, 1.0 / np.where(data > 0, data, 1.0),
                     np.sqrt(mu))
        return float(np.sum(np.log(w)))
    return float(np.sum(np.linalg.slogdet(data)[1]))


def error(noise: NoiseModel, r):
    """Total error contribution 0.5 ||r_w||^2, or rho(||r_w||) for a robust
    model (reference: NoiseModelFactor::error). Constrained rows are
    weighted by mu (reference: Constrained::distance)."""
    rw = whiten_residual(noise, r)
    if noise.kind == "constrained":
        wmu = torch.where(noise.data > 0, torch.ones_like(noise.data),
                          noise.k)
        return 0.5 * (wmu * rw * rw).sum()
    sq = (rw * rw).sum(-1)
    if noise.robust == "none":
        return 0.5 * sq.sum()
    # 1e-300 under the root, as in the JAX package: in float64 a zero row
    # gets e = 1e-150, not 0, so a row whose tuning constant k is 0 (an
    # ISAM2 engine's capacity padding) adds rho(1e-150 / 0) = 0 to the
    # error, where e / k = 0 / 0 would make it NaN. In float32 the
    # constant rounds to 0, in both packages.
    return robust_loss(noise.robust, torch.sqrt(sq + 1e-300), noise.k).sum()


# -- m-estimators (reference: linear/LossFunctions.h:66-555) -----------------

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
