"""Constrained optimization: equality constraints by penalty and augmented
Lagrangian methods.

JAX counterpart: gtsam_personal_tpu/nonlinear/constrained.py (all of it;
reference: gtsam/constrained/, NonlinearEqualityConstraint and the penalty
optimizers over the standard ones). Constraints are ordinary residual
functions; the outer loop rescales their weights (penalty) or keeps
multiplier estimates on the host (augmented Lagrangian) and solves again
with the batched LM.
"""

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers


@dataclass
class ConstrainedParams:
    mu_initial: float = 10.0          # penalty weight
    mu_factor: float = 4.0
    max_outer_iterations: int = 12
    constraint_tol: float = 1e-6
    inner: optimizers.Params = field(
        default_factory=lambda: optimizers.Params(max_iterations=25))


def _weighted(batch: FactorBatch, sqrt_mu: float, shift=None) -> FactorBatch:
    """The constraint batch scaled by sqrt(mu); optionally its residual
    shifted by lambda/mu (augmented Lagrangian)."""
    fn = batch.residual_fn
    if shift is None:
        def residual(xs, meas):
            return fn(xs, meas) * meas["__sqrt_mu"][0]
    else:
        def residual(xs, meas):
            return (fn(xs, meas) + meas["__shift"]) * meas["__sqrt_mu"][0]
    dtype = next(iter(batch.meas.values())).dtype if batch.meas else \
        torch.float64
    meas = dict(batch.meas)
    meas["__sqrt_mu"] = torch.full((batch.size, 1), float(sqrt_mu),
                                   dtype=dtype, device=batch.idx.device)
    if shift is not None:
        meas["__shift"] = torch.as_tensor(np.asarray(shift), dtype=dtype,
                                          device=batch.idx.device)
    return FactorBatch(batch.name + "_penalized", residual, batch.groups,
                       batch.rdim, batch.idx, meas, batch.noise)


def constraint_violation(batches: Sequence[FactorBatch],
                         values: Values) -> float:
    """The max-norm of all constraint residuals."""
    worst = 0.0
    for b in batches:
        r = b.residuals(values)
        worst = max(worst, float(r.abs().max()) if r.numel() else 0.0)
    return worst


def optimize_penalty(graph: FactorGraph, values: Values,
                     eq_constraints: Sequence[FactorBatch],
                     params: ConstrainedParams = ConstrainedParams()):
    """Quadratic penalty: min f(x) + mu/2 ||c(x)||^2, mu growing until the
    constraints hold (reference: the penalty optimizer of
    gtsam/constrained/)."""
    mu = params.mu_initial
    res = None
    for _ in range(params.max_outer_iterations):
        batches = list(graph.batches) + [
            _weighted(c, np.sqrt(mu)) for c in eq_constraints]
        res = optimizers.optimize_lm(FactorGraph(batches), values,
                                     params.inner)
        values = res.values
        if constraint_violation(eq_constraints, values) < \
                params.constraint_tol:
            break
        mu *= params.mu_factor
    return values, res


def optimize_augmented_lagrangian(
        graph: FactorGraph, values: Values,
        eq_constraints: Sequence[FactorBatch],
        params: ConstrainedParams = ConstrainedParams()):
    """Augmented Lagrangian: multiplier estimates lambda, so that mu need
    not grow without bound: min f + mu/2 ||c + lambda/mu||^2."""
    mu = params.mu_initial
    lambdas = [np.zeros((c.size, c.rdim)) for c in eq_constraints]
    res = None
    for _ in range(params.max_outer_iterations):
        batches = list(graph.batches) + [
            _weighted(c, np.sqrt(mu), shift=lam / mu)
            for c, lam in zip(eq_constraints, lambdas)]
        res = optimizers.optimize_lm(FactorGraph(batches), values,
                                     params.inner)
        values = res.values
        viol = 0.0
        for k, c in enumerate(eq_constraints):
            ck = c.residuals(values).cpu().numpy()
            lambdas[k] = lambdas[k] + mu * ck
            viol = max(viol, float(np.abs(ck).max()) if ck.size else 0.0)
        if viol < params.constraint_tol:
            break
        mu *= params.mu_factor
    return values, res


def nonlinear_equality(group: str, i: int, value, weight: float = 1e6, *,
                       device="cuda", dtype=torch.float64):
    """NonlinearEquality: pin a variable to a value by a large-weight prior
    (reference: nonlinear/NonlinearEquality.h; its Constrained noise and
    special QR become a penalty here, as in the JAX package)."""
    from gtsam_personal_tpu_torch.slam import factors as F
    dev = config.device(device)
    d = manifolds.get(group).dim
    return FactorBatch(
        f"equality_{group}", F.make_prior_residual(group), (group,), d,
        torch.tensor([[i]], dtype=torch.int64, device=dev),
        {"prior": torch.as_tensor(np.asarray(value)[None], dtype=dtype,
                                  device=dev)},
        NoiseModel("diag", torch.full((1, d), float(np.sqrt(weight)),
                                      dtype=dtype, device=dev)))
