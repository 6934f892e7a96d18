"""Kalman filtering: the linear filter and the extended filter on
manifolds.

JAX counterpart: gtsam_personal_tpu/linear/kalman.py (all of it; reference:
linear/KalmanFilter.h:89, the linear filter as elimination on a
two-variable chain, here in the equivalent covariance form; and
nonlinear/ExtendedKalmanFilter.h, the filter by relinearization).

`kf_run` is a Python loop over the steps where the JAX package runs one
`lax.scan`: each step is a handful of small products that depend on the
step before, and the filters its callers run are short.
"""

from typing import Callable, NamedTuple

import torch

from gtsam_personal_tpu_torch.core import manifolds


class GaussianState(NamedTuple):
    mean: torch.Tensor    # [d] or a manifold point
    cov: torch.Tensor     # [d, d] tangent covariance


def kf_predict(state: GaussianState, F, B, u, Q) -> GaussianState:
    """x' = F x + B u + w, w ~ N(0, Q) (KalmanFilter::predict)."""
    return GaussianState(F @ state.mean + B @ u, F @ state.cov @ F.T + Q)


def kf_update(state: GaussianState, H, z, R) -> GaussianState:
    """Measurement z = H x + v, v ~ N(0, R) (KalmanFilter::update)."""
    S = H @ state.cov @ H.T + R
    K = torch.linalg.solve(S, H @ state.cov).T
    mean = state.mean + K @ (z - H @ state.mean)
    d = state.mean.shape[0]
    P = (torch.eye(d, dtype=state.cov.dtype, device=state.cov.device)
         - K @ H) @ state.cov
    return GaussianState(mean, 0.5 * (P + P.T))


def kf_run(state: GaussianState, F, B, Q, H, R, us, zs):
    """The whole filter over the controls `us` [T, ...] and measurements
    `zs` [T, ...]: (final state, means [T, d])."""
    means = []
    for u, z in zip(us, zs):
        state = kf_update(kf_predict(state, F, B, u, Q), H, z, R)
        means.append(state.mean)
    return state, torch.stack(means)


class ExtendedKalmanFilter:
    """EKF over a manifold-valued state (reference:
    nonlinear/ExtendedKalmanFilter.h, there two-factor elimination; here the
    equivalent tangent-space covariance recursion with Jacobians by
    forward-mode differentiation through the retraction)."""

    def __init__(self, group: str, x0, P0):
        self.m = manifolds.get(group)
        self.state = GaussianState(x0, P0)

    def _zero(self):
        cov = self.state.cov
        return cov.new_zeros(self.m.dim)

    def predict(self, motion: Callable, Q):
        """x' = motion(x); F = d local(motion(x), motion(x [+] d)) / dd at
        0."""
        x = self.state.mean
        fx = motion(x)

        def lifted(d):
            return self.m.local(fx, motion(self.m.retract(x, d)))

        # one Jacobian, not under vmap: torch.linalg.solve's batched
        # forward-mode derivative fault (ROADMAP queue 3 B1) cannot arise
        F = torch.func.jacfwd(lifted)(self._zero())
        self.state = GaussianState(fx, F @ self.state.cov @ F.T + Q)
        return self.state

    def update(self, h: Callable, z, R):
        """Measurement z = h(x) + v."""
        x = self.state.mean
        hx = h(x)

        def lifted(d):
            return h(self.m.retract(x, d))

        H = torch.func.jacfwd(lifted)(self._zero())    # not under vmap
        S = H @ self.state.cov @ H.T + R
        K = torch.linalg.solve(S, H @ self.state.cov).T
        mean = self.m.retract(x, K @ (z - hx))
        P = (torch.eye(self.m.dim, dtype=self.state.cov.dtype,
                       device=self.state.cov.device) - K @ H) @ self.state.cov
        self.state = GaussianState(mean, 0.5 * (P + P.T))
        return self.state
