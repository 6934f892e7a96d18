"""Incremental pose-graph smoothing with capacity-padded arrays.

JAX counterpart: gtsam_personal_tpu/nonlinear/incremental.py (all of it;
reference: the capability of ISAM2 / NonlinearISAM, bounded-cost updates as
measurements stream in). Fixed-capacity arrays of poses and between
factors live on the host with activity masks (an inactive slot holds the
identity and a zero sqrt information, so it adds nothing); every
`relinearize_every` additions a few warm-started damped Gauss-Newton
iterations with a PCG solve run on the device. The capacities grow by
doubling, as in the JAX package, where that bounds its compiles to O(log N)
over a sequence; here it keeps the host arrays' growth amortized.

SE(2) and SE(3) pose graphs (City10000-style streams: odometry and loop
closures, closures to any older pose; nothing is marginalized).
"""

from typing import Optional

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear import solvers
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.slam import factors as F


def _update(graph: FactorGraph, values: Values, lam, iters=3,
            pcg_maxiter=60):
    """`iters` damped Gauss-Newton iterations with PCG solves, each step
    kept only if it lowers the error; the decision stays on the device (the
    JAX package's `_update_jit`, a `lax.scan`). Returns (values, error as a
    0-dim tensor)."""
    err = graph.error(values)
    for _ in range(iters):
        lin = linearize(graph, values)
        delta = solvers.solve_pcg(lin, lam, maxiter=pcg_maxiter, tol=1e-6)
        new_values = values.retract(delta)
        new_err = graph.error(new_values)
        better = new_err < err
        values = Values({g: torch.where(better, new_values[g], x)
                         for g, x in values.blocks.items()})
        err = torch.minimum(err, new_err)
    return values, err


class IncrementalSmoother:
    def __init__(self, group: str = "se2", relinearize_every: int = 25,
                 iters_per_update: int = 3, pcg_maxiter: int = 60,
                 lam: float = 1e-5, dtype=np.float64, *, device="cuda"):
        self.group = group
        self.dim = manifolds.get(group).dim
        self.param_shape = manifolds.get(group).param_shape
        self.relin_every = relinearize_every
        self.iters = iters_per_update
        self.pcg_maxiter = pcg_maxiter
        self.lam = lam
        self.dtype = dtype
        self.device = config.device(device)
        self._tdtype = torch.from_numpy(np.zeros(0, dtype=dtype)).dtype

        self.cap_n = 64
        self.cap_f = 128
        self.n = 0          # active poses
        self.f = 0          # active between factors
        # inactive slots hold identity poses and measurements, so that
        # residuals and Jacobians stay finite (a zero sqrt information
        # weighs them out)
        self._identity = manifolds.get(group).identity(
            device="cpu", dtype=torch.float64).numpy().astype(dtype)
        self._poses = np.broadcast_to(
            self._identity, (self.cap_n,) + self.param_shape).copy()
        self._ij = np.zeros((self.cap_f, 2), dtype=np.int64)
        self._meas = np.broadcast_to(
            self._identity, (self.cap_f,) + self.param_shape).copy()
        self._sqrt = np.zeros((self.cap_f, self.dim, self.dim), dtype=dtype)
        self._prior = None  # (pose, sqrt_info)
        self._since_solve = 0
        self._residual_fn = F.make_between_residual(group)
        self._prior_fn = F.make_prior_residual(group)

    # -- growth --------------------------------------------------------------
    def _ensure(self, n, f):
        while n > self.cap_n:
            self.cap_n *= 2
            pad = np.broadcast_to(self._identity, self._poses.shape).copy()
            self._poses = np.concatenate([self._poses, pad])
        while f > self.cap_f:
            self.cap_f *= 2
            self._ij = np.concatenate([self._ij, np.zeros_like(self._ij)])
            pad = np.broadcast_to(self._identity, self._meas.shape).copy()
            self._meas = np.concatenate([self._meas, pad])
            self._sqrt = np.concatenate([self._sqrt,
                                         np.zeros_like(self._sqrt)])

    # -- streaming API -------------------------------------------------------
    def set_prior(self, pose0, sigmas):
        self._prior = (np.asarray(pose0, dtype=self.dtype),
                       np.diag(1.0 / np.asarray(sigmas, dtype=self.dtype)))
        self._ensure(1, self.f)
        if self.n == 0:
            self._poses[0] = pose0
            self.n = 1

    def add_pose(self, init):
        self._ensure(self.n + 1, self.f)
        self._poses[self.n] = np.asarray(init, dtype=self.dtype)
        self.n += 1
        return self.n - 1

    def add_between(self, i, j, measured, sqrt_info):
        """sqrt_info: [d, d] upper factor with S^T S = information."""
        self._ensure(self.n, self.f + 1)
        self._ij[self.f] = (i, j)
        self._meas[self.f] = np.asarray(measured, dtype=self.dtype)
        self._sqrt[self.f] = np.asarray(sqrt_info, dtype=self.dtype)
        self.f += 1
        self._since_solve += 1
        if self._since_solve >= self.relin_every:
            self.solve()

    # -- solving -------------------------------------------------------------
    def _graph_values(self):
        g = self.group

        def t(a):
            return torch.as_tensor(a, dtype=self._tdtype, device=self.device)

        batches = [FactorBatch(
            f"between_{g}", self._residual_fn, (g, g), self.dim,
            torch.as_tensor(self._ij, device=self.device),
            {"measured": t(self._meas)}, NoiseModel("full", t(self._sqrt)))]
        if self._prior is not None:
            p0, S0 = self._prior
            batches.append(FactorBatch(
                f"prior_{g}", self._prior_fn, (g,), self.dim,
                torch.zeros((1, 1), dtype=torch.int64, device=self.device),
                {"prior": t(p0[None])}, NoiseModel("full", t(S0[None]))))
        return FactorGraph(batches), Values({g: t(self._poses)})

    def solve(self, iters: Optional[int] = None):
        graph, values = self._graph_values()
        vals, err = _update(graph, values,
                            torch.tensor(self.lam, dtype=self._tdtype,
                                         device=self.device),
                            iters=iters or self.iters,
                            pcg_maxiter=self.pcg_maxiter)
        self._poses = vals[self.group].cpu().numpy().copy()
        self._since_solve = 0
        return float(err)

    def estimate(self):
        return self._poses[: self.n].copy()
