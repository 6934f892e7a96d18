"""Graduated non-convexity (GNC) robust optimization.

JAX counterpart: gtsam_personal_tpu/nonlinear/gnc.py (all of it;
reference: GncOptimizer, nonlinear/GncOptimizer.h:183-247, with the TLS
and GM surrogates): alternate (1) weighted least-squares solves, the
weights scaling each factor's sqrt information, and (2) closed-form weight
updates under a graduated mu schedule (updateMu, GncOptimizer.h:317). The
weights live on the host in numpy, as in the JAX package; the chi-squared
inlier threshold is scipy.stats' quantile (the reference vendors cephes for
the same quantile, nonlinear/internal/ChiSquaredInverse.h:24).
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.noise import NoiseModel, whiten_residual
from gtsam_personal_tpu_torch.nonlinear import optimizers


@dataclass
class GncParams:
    loss_type: str = "tls"            # 'tls' | 'gm'
    max_outer_iterations: int = 20
    mu_step: float = 1.4
    barc_sq: Optional[float] = None   # inlier threshold on squared whitened err
    inlier_prob: float = 0.99         # used to derive barc_sq via chi2 quantile
    weights_tol: float = 1e-4
    inner: optimizers.Params = optimizers.Params(max_iterations=20)


def _chi2_quantile(p, dof):
    from scipy.stats import chi2
    return float(chi2.ppf(p, dof))


def _scale_batch(batch: FactorBatch, w: torch.Tensor) -> FactorBatch:
    """Scale the factors' weights (sqrt(w) on the whitened system)."""
    sw = torch.sqrt(torch.clamp(w, 0.0, 1.0))
    noise = batch.noise
    if noise.kind == "unit":
        nm = NoiseModel("diag", sw[:, None] * torch.ones(
            (batch.size, batch.rdim), dtype=sw.dtype, device=sw.device))
    elif noise.kind == "diag":
        nm = NoiseModel("diag", noise.data * sw[:, None])
    else:
        nm = NoiseModel("full", noise.data * sw[:, None, None])
    return FactorBatch(batch.name, batch.residual_fn, batch.groups,
                       batch.rdim, batch.idx, batch.meas, nm)


def optimize_gnc(graph: FactorGraph, values: Values, robust_batch_index: int,
                 params: GncParams = GncParams()):
    """GNC with the factors of `graph.batches[robust_batch_index]` treated
    as outlier-contaminated; every other batch stays as it is.

    Returns (values, weights as numpy [K], result)."""
    rb = graph.batches[robust_batch_index]
    K = rb.size
    barc_sq = params.barc_sq or _chi2_quantile(params.inlier_prob, rb.rdim)

    def sq_errors(vals):
        rw = whiten_residual(rb.noise, rb.residuals(vals))
        return (rw * rw).sum(-1).cpu().numpy()

    # mu from the largest residual (GncOptimizer::initializeMu)
    e2 = sq_errors(values)
    if params.loss_type == "gm":
        mu = 2.0 * float(e2.max()) / barc_sq if e2.max() > 0 else 1.0
    else:  # tls
        denom = 2.0 * float(e2.max()) / barc_sq - 1.0
        mu = 1.0 / denom if denom > 0 else 1e3  # already all-inlier

    w = np.ones(K)
    result = None
    for outer in range(params.max_outer_iterations):
        # weights from the CURRENT estimate, then the weighted solve
        # (GncOptimizer::calculateWeights; updating before the first solve
        # keeps gross outliers from dragging the initial basin)
        e2 = sq_errors(values)
        if params.loss_type == "gm":
            w_new = (mu * barc_sq / (e2 + mu * barc_sq)) ** 2
        else:  # tls
            upper = (mu + 1.0) / mu * barc_sq
            lower = mu / (mu + 1.0) * barc_sq
            w_new = np.clip(np.sqrt(barc_sq * mu * (mu + 1.0)
                                    / np.maximum(e2, 1e-30)) - mu, 0.0, 1.0)
            w_new = np.where(e2 >= upper, 0.0,
                             np.where(e2 <= lower, 1.0, w_new))
        converged = outer > 0 and np.abs(w_new - w).max() < params.weights_tol
        w = w_new

        first = next(iter(values.blocks.values()))
        wt = torch.as_tensor(w, dtype=first.dtype, device=first.device)
        weighted = FactorGraph([
            _scale_batch(b, wt) if i == robust_batch_index else b
            for i, b in enumerate(graph.batches)])
        result = optimizers.optimize_lm(weighted, values, params.inner)
        values = result.values

        # mu schedule (GncOptimizer::updateMu)
        if params.loss_type == "gm":
            mu = max(mu / params.mu_step, 1.0)
            if converged and abs(mu - 1.0) < 1e-9:
                break
        else:
            mu = mu * params.mu_step
            if converged:
                break
    return values, w, result
