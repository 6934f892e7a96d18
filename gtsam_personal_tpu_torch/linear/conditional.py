"""Gaussian conditionals and the GaussianBayesNet: sequential elimination and
back-substitution.

JAX counterpart: gtsam_personal_tpu/linear/conditional.py (all of it;
reference: GaussianConditional::solve, linear/GaussianConditional.h:200;
GaussianBayesNet::optimize, optimizeGradientSearch, backSubstitute(Transpose)
and sample, linear/GaussianBayesNet.h:123, 203, 249-257; EliminateQR,
linear/JacobianFactor.cpp:804; EliminateCholesky,
linear/HessianFactor.cpp:516).

The Bayes net is ONE upper-triangular factor R, a right-hand side d and a
variable permutation over the flat tangent space, made either by the
permuted Cholesky factor of the assembled normal equations
(`method="cholesky"`) or by a dense QR of the whitened Jacobian stack
(`method="qr"`, which never squares the condition number). A
`GaussianConditional` is a view of one variable's rows of R. Every solve is
a `torch.linalg.solve_triangular`.

A system that is not positive definite gives NaN factors, as
`jnp.linalg.cholesky` does (solvers.cholesky_nan), and LM rejects the try.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Layout
from gtsam_personal_tpu_torch.linear.linearize import (GaussianGraph,
                                                       LinearBatch,
                                                       linearize_batch)
from gtsam_personal_tpu_torch.linear.noise import (NoiseModel,
                                                   _constrained_weights)
from gtsam_personal_tpu_torch.linear.solvers import cholesky_nan


def _upper_solve(R, b):
    """x with R x = b, R upper triangular; b a vector."""
    return torch.linalg.solve_triangular(R, b[:, None], upper=True)[:, 0]


class GaussianConditional:
    """View of one variable's rows of the Bayes net: p(x_f | parents) with
    R_ff x_f + sum_p S_fp x_p = d_f (reference: GaussianConditional.h)."""

    def __init__(self, bn: "GaussianBayesNet", pos: int):
        self.bn = bn
        self.group, self.index, self.off, self.dim = bn.order[pos]

    @property
    def R(self):
        o, d = self.off, self.dim
        return self.bn.Rmat[o:o + d, o:o + d]

    @property
    def S(self):
        """Parent block row (everything right of the frontal block)."""
        o, d = self.off, self.dim
        return self.bn.Rmat[o:o + d, o + d:]

    @property
    def d(self):
        o, d = self.off, self.dim
        return self.bn.dvec[o:o + d]

    def solve(self, parents_flat: torch.Tensor) -> torch.Tensor:
        """x_f = R_ff^{-1} (d_f - S x_parents): one back-substitution step
        (reference: GaussianConditional::solve)."""
        return _upper_solve(self.R, self.d - self.S @ parents_flat)


class GaussianBayesNet:
    """The result of sequential elimination: R x_perm = d over the flat
    tangent space, and the elimination order [(group, index, offset,
    dim)]."""

    def __init__(self, Rmat: torch.Tensor, dvec: torch.Tensor,
                 order: List[Tuple[str, int, int, int]], layout: Layout,
                 perm: np.ndarray):
        self.Rmat = Rmat          # [D, D] upper triangular (permuted coords)
        self.dvec = dvec          # [D]
        self.order = order
        self.layout = layout
        self.perm = perm          # permuted position -> original flat index
        self._iperm = np.argsort(perm)

    # -- solves ---------------------------------------------------------------
    def _index(self, a):
        return torch.as_tensor(a, device=self.Rmat.device)

    def _unpermute(self, x_p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.layout.unflatten(x_p[self._index(self._iperm)])

    def _permute(self, delta: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.layout.flatten(delta)[self._index(self.perm)]

    def optimize(self) -> Dict[str, torch.Tensor]:
        """Back-substitution solve of R x = d (reference: optimize)."""
        return self._unpermute(_upper_solve(self.Rmat, self.dvec))

    def optimize_gradient_search(self) -> Dict[str, torch.Tensor]:
        """The steepest-descent (Cauchy) point of 0.5 ||R x - d||^2, the
        exact minimizer along the gradient: dogleg's second anchor
        (reference: optimizeGradientSearch)."""
        g = self.Rmat.T @ self.dvec            # the descent direction
        Rg = self.Rmat @ g
        alpha = (g @ g) / torch.clamp(Rg @ Rg, min=1e-300)
        return self._unpermute(alpha * g)

    def back_substitute(self, rhs: Dict[str, torch.Tensor]):
        """Solve R x = rhs (reference: backSubstitute)."""
        return self._unpermute(_upper_solve(self.Rmat, self._permute(rhs)))

    def back_substitute_transpose(self, rhs: Dict[str, torch.Tensor]):
        """Solve R^T x = rhs (reference: backSubstituteTranspose)."""
        x = torch.linalg.solve_triangular(
            self.Rmat.T, self._permute(rhs)[:, None], upper=False)[:, 0]
        return self._unpermute(x)

    def sample_from(self, eps: torch.Tensor,
                    mean: Optional[Dict[str, torch.Tensor]] = None):
        """The draw for white noise `eps` [D]: x = R^{-1} (d + eps), plus
        `mean` if given; distributed N(R^{-1} d, (R^T R)^{-1}) for eps ~
        N(0, I)."""
        out = self._unpermute(_upper_solve(self.Rmat, self.dvec + eps))
        if mean is not None:
            out = {g: out[g] + mean[g] for g in out}
        return out

    def sample(self, generator: torch.Generator,
               mean: Optional[Dict[str, torch.Tensor]] = None):
        """Draw x ~ N(mean, (R^T R)^{-1}) by back-substituting white noise
        drawn from `generator`, which lives on the Bayes net's device
        (reference: GaussianBayesNet::sample)."""
        eps = torch.randn(self.Rmat.shape[0], generator=generator,
                          dtype=self.Rmat.dtype, device=self.Rmat.device)
        return self.sample_from(eps, mean)

    def log_determinant(self):
        """sum log |R_ii| (reference: GaussianBayesNet::logDeterminant)."""
        return torch.log(torch.abs(torch.diagonal(self.Rmat))).sum()

    def error(self, delta: Dict[str, torch.Tensor]):
        r = self.Rmat @ self._permute(delta) - self.dvec
        return 0.5 * (r @ r)

    # -- conditional access ---------------------------------------------------
    def __len__(self):
        return len(self.order)

    def conditional(self, pos: int) -> GaussianConditional:
        return GaussianConditional(self, pos)

    def optimize_stepwise(self) -> Dict[str, torch.Tensor]:
        """Variable-at-a-time back-substitution through the conditionals,
        as the reference's BayesNet::optimize loop (the slow path, for
        tests)."""
        x = self.Rmat.new_zeros(self.Rmat.shape[0])
        for pos in reversed(range(len(self.order))):
            c = self.conditional(pos)
            o, d = c.off, c.dim
            x[o:o + d] = c.solve(x[o + d:])
        return self._unpermute(x)


def _make_order(layout: Layout, ordering):
    """ordering: a list of (group, index), or None (natural). Returns (the
    order with offsets, the permutation array)."""
    if ordering is None:
        ordering = [(g, i) for g in layout.groups
                    for i in range(layout.counts[g])]
    order = []
    perm = np.zeros(layout.total_dim, dtype=np.int64)
    off = 0
    for (g, i) in ordering:
        d = layout.dims[g]
        src = layout.var_offset(g, i)
        perm[off:off + d] = np.arange(src, src + d)
        order.append((g, i, off, d))
        off += d
    if off != layout.total_dim:
        raise ValueError("the ordering must cover every variable once")
    return order, perm


def eliminate_sequential(lin: GaussianGraph, layout: Layout,
                         ordering: Optional[Sequence[Tuple[str, int]]] = None,
                         lam=0.0, method: str = "cholesky"
                         ) -> GaussianBayesNet:
    """Sequential (dense) elimination of the linearized system into a
    GaussianBayesNet (reference: eliminateSequential,
    inference/EliminateableFactorGraph.h:117).

    method="cholesky": the permuted Cholesky factor of the normal equations
      (EliminateCholesky).
    method="qr": dense QR of the whitened Jacobian stack, which never forms
      J^T J (EliminateQR). Damping appends sqrt(lam) I rows, as LM's
      buildDampedSystem does; the signs are fixed so that diag(R) > 0.
    `lam` is a float or a 0-dim tensor."""
    order, perm = _make_order(layout, ordering)
    r0 = lin.batches[0].r
    permj = torch.as_tensor(perm, device=r0.device)
    D = layout.total_dim
    lam = torch.as_tensor(lam, dtype=r0.dtype, device=r0.device)
    eye = torch.eye(D, dtype=r0.dtype, device=r0.device)
    if method == "cholesky":
        H, g = lin.assemble_dense(layout)
        L = cholesky_nan(H[permj][:, permj] + lam * eye)
        d = torch.linalg.solve_triangular(L, -g[permj][:, None],
                                          upper=False)[:, 0]
        return GaussianBayesNet(L.T, d, order, layout, perm)
    if method == "qr":
        A, b = dense_jacobian(lin, layout)
        Ap = torch.cat([A[:, permj], torch.sqrt(lam) * eye])
        b = torch.cat([b, b.new_zeros(D)])
        Q, R = torch.linalg.qr(Ap, mode="reduced")
        d = -(Q.T @ b)
        diag = torch.diagonal(R)
        s = torch.sign(torch.where(diag == 0, torch.ones_like(diag), diag))
        return GaussianBayesNet(s[:, None] * R, s * d, order, layout, perm)
    raise ValueError(f"unknown elimination method {method!r}")


def dense_jacobian(lin: GaussianGraph, layout: Layout):
    """The whole whitened system stacked densely: A [rows, D], b [rows]
    (reference: GaussianFactorGraph::jacobian())."""
    r0 = lin.batches[0].r
    rows = sum(b.r.shape[0] * b.r.shape[1] for b in lin.batches)
    A = r0.new_zeros((rows, layout.total_dim))
    bvec = r0.new_zeros(rows)
    row0 = 0
    for b in lin.batches:
        K, rdim = b.r.shape
        rr = row0 + torch.arange(K * rdim, device=r0.device).view(K, rdim)
        bvec[rr] = b.r
        for s, g in enumerate(b.groups):
            d = layout.dims[g]
            cols = ((layout.offsets[g] + b.idx[:, s] * d)[:, None]
                    + torch.arange(d, device=r0.device))
            A.index_put_((rr[:, :, None], cols[:, None, :]), b.Js[s],
                         accumulate=True)
        row0 += K * rdim
    return A, bvec


def solve_qr(lin: GaussianGraph, layout: Layout, lam=0.0):
    """Dense QR solve of the (damped) least-squares system, the
    high-accuracy option (reference: EliminateQR + optimize)."""
    return eliminate_sequential(lin, layout, lam=lam, method="qr").optimize()


# ---------------------------------------------------------------------------
# hard equality constraints: the exact route for constrained noise models
# (reference: the special-pivot QR of NoiseModel::Constrained::QR,
# linear/NoiseModel.cpp, which eliminates the infinite-information rows
# first)
# ---------------------------------------------------------------------------

def split_constrained(graph: FactorGraph, values, layout: Layout):
    """Linearize `graph`, pulling the sigma == 0 rows of constrained-noise
    batches out as exact linear equality constraints.

    Returns (lin, E, e): `lin` is the whitened GaussianGraph of every soft
    row (the constrained rows zeroed), and E delta + e = 0 stacks the hard
    rows densely ([m, D], [m])."""
    soft, E_rows, e_rows = [], [], []
    for b in graph.batches:
        if b.noise.kind != "constrained":
            soft.append(linearize_batch(b, values))
            continue
        sig = b.noise.data
        if sig.dim() != 1:
            raise ValueError("split_constrained requires shared per-batch "
                             "sigmas for constrained models")
        cmask = sig == 0.0
        # the raw linearization (unit noise), then the soft rows whitened
        raw = linearize_batch(FactorBatch(b.name, b.residual_fn, b.groups,
                                          b.rdim, b.idx, b.meas,
                                          NoiseModel("unit")), values)
        wsoft = torch.where(cmask, torch.zeros_like(sig),
                            _constrained_weights(sig))
        soft.append(LinearBatch(raw.groups, raw.idx,
                                tuple(J * wsoft[None, :, None]
                                      for J in raw.Js),
                                raw.r * wsoft[None, :]))
        K = raw.r.shape[0]
        ar = torch.arange(K, device=raw.r.device)
        for ci in torch.nonzero(cmask).flatten().tolist():
            Ei = raw.r.new_zeros((K, layout.total_dim))
            for s, g in enumerate(raw.groups):
                d = layout.dims[g]
                cols = ((layout.offsets[g] + raw.idx[:, s] * d)[:, None]
                        + torch.arange(d, device=raw.r.device))
                Ei.index_put_((ar[:, None], cols), raw.Js[s][:, ci, :],
                              accumulate=True)
            E_rows.append(Ei)
            e_rows.append(raw.r[:, ci])
    lin = GaussianGraph(soft, {g: layout.counts[g] for g in layout.groups})
    r0 = soft[0].r
    if E_rows:
        return lin, torch.cat(E_rows), torch.cat(e_rows)
    return lin, r0.new_zeros((0, layout.total_dim)), r0.new_zeros(0)


def solve_equality_constrained(lin: GaussianGraph, layout: Layout,
                               E: torch.Tensor, e: torch.Tensor, lam=0.0):
    """Exact solve of min ||J x + r||^2 + lam ||x||^2 s.t. E x + e = 0 by the
    nullspace method: x = x0 + Z y with E x0 = -e and Z an orthonormal
    nullspace basis of E.

    E must have full row rank (as the reference's constrained QR assumes),
    and the reduced problem A Z y = -(b + A x0) full column rank:
    `torch.linalg.lstsq` on a card has only the `gels` driver, which
    assumes it (the JAX package's SVD-based lstsq would return the
    minimum-norm solution of a rank-deficient system)."""
    A, b = dense_jacobian(lin, layout)
    D = layout.total_dim
    m = E.shape[0]
    if m == 0:
        return solve_qr(lin, layout, lam)
    # complete orthogonal decomposition by QR of E^T: E^T = Q [R; 0]
    Q, R = torch.linalg.qr(E.T, mode="complete")       # Q [D, D], R [D, m]
    y0 = torch.linalg.solve_triangular(R[:m, :].T, -e[:, None],
                                       upper=False)[:, 0]
    x0 = Q[:, :m] @ y0
    Z = Q[:, m:]                                       # nullspace basis
    if lam > 0.0:
        A = torch.cat([A, lam ** 0.5 * torch.eye(D, dtype=A.dtype,
                                                 device=A.device)])
        b = torch.cat([b, b.new_zeros(D)])
    y = torch.linalg.lstsq(A @ Z, -(b + A @ x0)[:, None]).solution[:, 0]
    return layout.unflatten(x0 + Z @ y)
