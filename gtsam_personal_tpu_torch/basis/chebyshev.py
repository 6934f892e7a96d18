"""Pseudospectral basis machinery: Chebyshev (second kind points), Fourier,
basis factors, and least-squares function fitting.

JAX counterpart: gtsam_personal_tpu/basis/chebyshev.py (all of it;
reference: gtsam/basis/, Basis -> weight / evaluation vectors, Chebyshev2
points, weights and differentiation matrix, FitBasis, BasisFactors'
EvaluationFactor as an ordinary factor on the coefficient vector).

Weights are tensors where their query points live; a query that is not a
tensor, and the differentiation matrix, go to `device` (the card unless the
caller names another) in float64. `fit_basis` builds the factor graph on
`device` and runs nonlinear/optimizers.py:optimize_gn.
"""

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers


def _query(x, device):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype=np.float64),
                           device=config.device(device or "cuda"))


# -- Chebyshev2: second-kind points (includes endpoints) ---------------------

def chebyshev2_points(n: int, a: float = -1.0, b: float = 1.0):
    """N points cos(pi k/(n-1)) mapped to [a, b], ascending, as numpy
    (reference: Chebyshev2::Points)."""
    k = np.arange(n)
    x = np.cos(np.pi * k / (n - 1))
    return (a + b) / 2 + (b - a) / 2 * x[::-1]


def chebyshev2_weights(x_query, n: int, a: float = -1.0, b: float = 1.0,
                       device=None):
    """Barycentric interpolation weights [..., n] at x_query [...]:
    f(x) = w(x) . f(points) (reference: Chebyshev2::CalculateWeights)."""
    x = _query(x_query, device)
    pts = torch.as_tensor(chebyshev2_points(n, a, b), dtype=x.dtype,
                          device=x.device)
    c = np.ones(n)
    c[0] = c[-1] = 0.5
    c = torch.as_tensor(c * (-1.0) ** np.arange(n), dtype=x.dtype,
                        device=x.device)
    d = x[..., None] - pts
    exact = d.abs() < 1e-14
    terms = c / torch.where(exact, torch.ones_like(d), d)
    w = terms / terms.sum(-1, keepdim=True)
    w_exact = exact.to(w.dtype)
    any_exact = exact.any(-1, keepdim=True)
    return torch.where(any_exact,
                       w_exact / w_exact.sum(-1, keepdim=True).clamp(min=1),
                       w)


def chebyshev2_differentiation_matrix(n: int, a: float = -1.0, b: float = 1.0,
                                      device=None):
    """Spectral differentiation matrix D with f'(points) = D f(points)
    (reference: Chebyshev2::DifferentiationMatrix), float64 on `device`."""
    pts = chebyshev2_points(n, a, b)
    c = np.ones(n)
    c[0] = c[-1] = 2.0
    c = c * (-1.0) ** np.arange(n)
    X = pts[:, None] - pts[None, :]
    D = np.outer(c, 1.0 / c) / (X + np.eye(n))
    D = D - np.diag(D.sum(axis=1))
    return torch.as_tensor(D, device=config.device(device or "cuda"))


# -- Fourier basis ------------------------------------------------------------

def fourier_weights(x_query, n: int, device=None):
    """[1, cos x, sin x, cos 2x, sin 2x, ...] (reference: FourierBasis)."""
    x = _query(x_query, device)
    cols = [torch.ones_like(x)]
    for k in range(1, (n + 1) // 2 + 1):
        if len(cols) < n:
            cols.append(torch.cos(k * x))
        if len(cols) < n:
            cols.append(torch.sin(k * x))
    return torch.stack(cols[:n], dim=-1)


# -- Chebyshev first kind (polynomial basis T_k) ------------------------------

def chebyshev1_weights(x_query, n: int, a: float = -1.0, b: float = 1.0,
                       device=None):
    """[T_0(t), ..., T_{n-1}(t)] with t the affine map of x to [-1, 1]
    (reference: basis/Chebyshev.h Chebyshev1Basis)."""
    x = _query(x_query, device)
    t = (2.0 * x - (a + b)) / (b - a)
    cols = [torch.ones_like(t), t]
    for _ in range(2, n):
        cols.append(2.0 * t * cols[-1] - cols[-2])
    return torch.stack(cols[:n], dim=-1)


def chebyshev2_derivative_weights(x_query, n: int, a: float = -1.0,
                                  b: float = 1.0, device=None):
    """Weights d with f'(x) = d . f(points): barycentric evaluation of the
    spectrally differentiated interpolant (reference:
    Chebyshev2::DerivativeWeights)."""
    w = chebyshev2_weights(x_query, n, a, b, device)
    D = chebyshev2_differentiation_matrix(n, a, b, w.device).to(w.dtype)
    return w @ D


# -- Basis factors + FitBasis -------------------------------------------------

def evaluation_residual(xs, meas):
    """EvaluationFactor: predicted = w . coeffs (reference:
    BasisFactors.h)."""
    (coeffs,) = xs
    return ((meas["w"] * coeffs).sum() - meas["z"]).reshape(1)


def vector_evaluation_residual(m: int):
    """VectorEvaluationFactor<M>: the unknown is an [M, N] coefficient matrix
    stored flat; predicted vector = C w (reference: BasisFactors.h
    VectorEvaluationFactor)."""

    def residual(xs, meas):
        (coeffs,) = xs
        C = coeffs.reshape(m, -1)
        return C @ meas["w"] - meas["z"]

    residual.__name__ = f"basis_vector_eval_{m}"
    return residual


def derivative_residual(xs, meas):
    """DerivativeFactor: predicted f'(x) = d . coeffs with d the derivative
    weights (reference: BasisFactors.h DerivativeFactor)."""
    (coeffs,) = xs
    return ((meas["d"] * coeffs).sum() - meas["z"]).reshape(1)


def vector_derivative_residual(m: int):
    """VectorDerivativeFactor<M> (reference: BasisFactors.h)."""

    def residual(xs, meas):
        (coeffs,) = xs
        C = coeffs.reshape(m, -1)
        return C @ meas["d"] - meas["z"]

    residual.__name__ = f"basis_vector_deriv_{m}"
    return residual


def fit_basis(xs_samples, zs_samples, n: int, basis: str = "chebyshev2",
              a: float = -1.0, b: float = 1.0, sigma: float = 1.0,
              device="cuda"):
    """FitBasis: least-squares fit of basis coefficients to samples, in
    float64 on `device`.

    Returns (coefficients [n] as numpy, the optimizer's Result); for
    chebyshev2 the coefficients are the values at the Chebyshev points."""
    dev = config.device(device)
    xs = torch.as_tensor(np.asarray(xs_samples, dtype=np.float64),
                         device=dev)
    zs = torch.as_tensor(np.asarray(zs_samples, dtype=np.float64),
                         device=dev)
    K = xs.shape[0]
    if basis == "chebyshev2":
        W = chebyshev2_weights(xs, n, a, b)
    elif basis == "chebyshev1":
        W = chebyshev1_weights(xs, n, a, b)
    elif basis == "fourier":
        W = fourier_weights(xs, n)
    else:
        raise ValueError(basis)

    group = manifolds.vector_space(f"basis_coeffs_{n}", n)
    batch = FactorBatch(
        "basis_eval", evaluation_residual, (group.name,), 1,
        torch.zeros((K, 1), dtype=torch.int64, device=dev),
        {"w": W, "z": zs},
        NoiseModel("diag", torch.full((K, 1), 1.0 / sigma,
                                      dtype=torch.float64, device=dev)))
    init = Values({group.name: torch.zeros((1, n), dtype=torch.float64,
                                           device=dev)})
    res = optimizers.optimize_gn(FactorGraph([batch]), init,
                                 optimizers.Params(max_iterations=3))
    return res.values[group.name][0].cpu().numpy(), res
