"""Misc nonlinear factors: LinearContainerFactor, FunctorizedFactor,
WhiteNoiseFactor.

JAX counterpart: gtsam_personal_tpu/nonlinear/misc.py (all of it;
reference: nonlinear/LinearContainerFactor.h, FunctorizedFactor.h and
WhiteNoiseFactor.h):
- a linear container wraps an already linearized Gaussian factor into a
  nonlinear graph, anchored at its linearization point;
- a functorized factor is a factor from any callable that predicts a
  measurement (any residual function is a factor here; the helpers exist
  for the reference's names);
- the white-noise factor estimates the mean and precision of zero-mean
  Gaussian white noise from scalar data, with the log-normalization term of
  the negative log-likelihood.
"""

from typing import Callable, Sequence

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import GraphBuilder


# -- LinearContainerFactor ----------------------------------------------------

def make_linear_container_residual(groups: Sequence[str]):
    """Residual of a wrapped linear (Jacobian) factor: r(x) = sum_s A_s
    local(anchor_s, x_s) - b. At x = anchor it is -b; Gauss-Newton on it
    reproduces the original linear factor exactly."""
    ms = [manifolds.get(g) for g in groups]

    def residual(xs, meas):
        acc = -meas["b"]
        for s, (m, x) in enumerate(zip(ms, xs)):
            acc = acc + meas[f"A{s}"] @ m.local(meas[f"anchor{s}"], x)
        return acc

    residual.__name__ = "linear_container_" + "_".join(groups)
    return residual


def add_linear_container(builder: GraphBuilder, groups: Sequence[str],
                         idx: Sequence[int], As: Sequence[np.ndarray],
                         b: np.ndarray, anchors: Sequence[np.ndarray],
                         noise: dict = None):
    """Add a wrapped linear factor |sum_s A_s xi_s - b|^2 on the variables
    (groups[s], idx[s]), xi_s the tangent of x_s at anchors[s]."""
    b = np.asarray(b)
    meas = {"b": b}
    for s, (A, anc) in enumerate(zip(As, anchors)):
        meas[f"A{s}"] = np.asarray(A)
        meas[f"anchor{s}"] = np.asarray(anc)
    builder.add("linear_container_" + "_".join(groups),
                make_linear_container_residual(tuple(groups)),
                tuple(groups), b.shape[-1], list(idx), meas,
                noise or {"kind": "unit"})


# -- FunctorizedFactor --------------------------------------------------------

def make_functorized_residual(fn: Callable, name: str = "functorized"):
    """FunctorizedFactor<R, T>: r = fn(x) - z for any callable of torch
    tensors."""

    def residual(xs, meas):
        (x,) = xs
        return torch.atleast_1d(fn(x) - meas["z"])

    residual.__name__ = name
    return residual


def make_functorized2_residual(fn: Callable, name: str = "functorized2"):
    """FunctorizedFactor2: r = fn(x1, x2) - z."""

    def residual(xs, meas):
        x1, x2 = xs
        return torch.atleast_1d(fn(x1, x2) - meas["z"])

    residual.__name__ = name
    return residual


# -- WhiteNoiseFactor ---------------------------------------------------------

def white_noise_residual(xs, meas):
    """Mean and log-precision of zero-mean Gaussian white noise from a
    scalar datum z (reference error 0.5 log(2pi) - 0.5 u + 0.5 e^u (z -
    mu)^2, u = log(precision)), as two residuals whose summed square is
    that error up to a constant on u < u_max:
      r0 = e^{u/2} (z - mu)              (the whitened datum)
      r1 = sqrt(u_max - u)               (0.5 r1^2 = -0.5 u + const)
    u_max (meas["umax"]) caps the precision. Variables: the mean and the
    log-precision, each a scalar ("r1") group. The scalars keep a trailing
    axis of 1 (ROADMAP queue 3 B2)."""
    mu, u = xs
    d = meas["z"] - mu
    r0 = torch.exp(0.5 * u) * d
    r1 = torch.sqrt(torch.clamp(meas["umax"] - u, min=1e-6))
    return torch.cat([r0, r1])


def white_noise_mle(z: np.ndarray):
    """Closed-form ML (mean, precision) of scalar data: the oracle of the
    white-noise factor's tests."""
    z = np.asarray(z, dtype=np.float64)
    mu = z.mean()
    var = np.mean((z - mu) ** 2)
    return float(mu), float(1.0 / max(var, 1e-300))
