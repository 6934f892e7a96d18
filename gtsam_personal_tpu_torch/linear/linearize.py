"""Batched linearization: the whole graph's Jacobians in a few vmaps.

JAX counterpart: gtsam_personal_tpu/linear/linearize.py (all of it;
reference: NonlinearFactorGraph::linearize and GaussianFactorGraph.h:73).
The Jacobian of a factor is taken by forward-mode differentiation THROUGH
the manifold retraction, J = d residual(x [+] delta) / d delta at delta = 0,
which is the local-coordinates Jacobian that Gauss-Newton needs:
`jax.vmap(jax.jacfwd(...))` there, `torch.func.vmap(torch.func.jacfwd(...))`
here.

The result is a `GaussianGraph` in whitened Jacobian (sqrt) form, stored as
per-batch block tensors. Its accumulations are `index_add_` /
`index_put_(accumulate=True)` on int64 indices: on a CUDA device these are
atomic adds, so a float32 sum may differ in its last bits from run to run.
"""

import threading
from typing import Dict, Sequence, Tuple

import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.values import Layout, Values
from gtsam_personal_tpu_torch.linear.noise import whiten_system

# torch's forward-mode AD levels are global to the process, not to a
# thread: two threads inside `jacfwd` at once exit each other's level.
# Ranks of a distributed solve run as threads in one process
# (tests/test_torch_parallel.py), so the linearization is taken one thread
# at a time.
_JACFWD_LOCK = threading.Lock()


class LinearBatch:
    """Whitened linearized factor batch: sum_s J_s delta_s + r, with
    J_s: [K, rdim, dim_s] and r: [K, rdim]."""

    def __init__(self, groups: Tuple[str, ...], idx: torch.Tensor,
                 Js: Tuple[torch.Tensor, ...], r: torch.Tensor,
                 sign: float = 1.0):
        self.groups = tuple(groups)
        self.idx = idx
        self.Js = tuple(Js)
        self.r = r
        self.sign = float(sign)   # -1.0: AntiFactor (subtract contribution)

    @property
    def size(self):
        return self.idx.shape[0]


class GaussianGraph:
    """The linear(ized) system min_delta 0.5 || J delta + r ||^2 as a list
    of LinearBatch, with every solver's entry points: matvec, gradient,
    preconditioner data and dense assembly."""

    def __init__(self, batches: Sequence[LinearBatch],
                 counts: Dict[str, int]):
        self.batches = list(batches)
        self.counts = dict(counts)

    # -- quadratic model ---------------------------------------------------
    def error_at_zero(self):
        """0.5 ||r||^2, the linearized cost at delta = 0."""
        return sum(b.sign * 0.5 * (b.r * b.r).sum() for b in self.batches)

    def zero_tangent(self):
        r = self.batches[0].r
        return {g: r.new_zeros((n, manifolds.get(g).dim))
                for g, n in self.counts.items()}

    def apply_J(self, delta):
        """Per-batch products u_b = sum_s J_s delta[g_s][idx_s]."""
        outs = []
        for b in self.batches:
            u = torch.zeros_like(b.r)
            for s, g in enumerate(b.groups):
                u = u + torch.einsum("kij,kj->ki", b.Js[s],
                                     delta[g][b.idx[:, s]])
            outs.append(u)
        return outs

    def apply_Jt(self, us):
        """delta-shaped accumulation of J^T u."""
        out = self.zero_tangent()
        for b, u in zip(self.batches, us):
            for s, g in enumerate(b.groups):
                out[g].index_add_(0, b.idx[:, s],
                                  torch.einsum("kij,ki->kj", b.Js[s], u),
                                  alpha=b.sign)
        return out

    def hessian_vector_product(self, delta):
        """(J^T J) delta, the CG matvec (reference:
        GaussianFactorGraph::multiplyHessianAdd)."""
        return self.apply_Jt(self.apply_J(delta))

    def gradient_at_zero(self):
        """J^T r, the gradient of 0.5 ||J delta + r||^2 at delta = 0
        (reference: GaussianFactorGraph::gradientAtZero)."""
        return self.apply_Jt([b.r for b in self.batches])

    def hessian_diagonal(self):
        """diag(J^T J) as a tangent-shaped dict (reference:
        GaussianFactorGraph::hessianDiagonal), for LM's diagonal damping."""
        out = self.zero_tangent()
        for b in self.batches:
            for s, g in enumerate(b.groups):
                out[g].index_add_(0, b.idx[:, s],
                                  (b.Js[s] * b.Js[s]).sum(1), alpha=b.sign)
        return out

    def hessian_block_diagonal(self):
        """Per-variable dense d x d blocks of J^T J, the block-Jacobi data
        (reference: Preconditioner 'BlockJacobi', linear/Preconditioner.h)."""
        r = self.batches[0].r
        out = {g: r.new_zeros((n, manifolds.get(g).dim,
                               manifolds.get(g).dim))
               for g, n in self.counts.items()}
        for b in self.batches:
            for s, g in enumerate(b.groups):
                out[g].index_add_(
                    0, b.idx[:, s],
                    torch.einsum("kij,kil->kjl", b.Js[s], b.Js[s]),
                    alpha=b.sign)
        return out

    # -- dense path (reference: GaussianFactorGraph::optimizeDensely) -------
    def assemble_dense(self, layout: Layout):
        """The full (D, D) normal-equations matrix H = J^T J and the gradient
        g = J^T r, by block scatter-add."""
        r = self.batches[0].r
        D = layout.total_dim
        H = r.new_zeros((D, D))
        gvec = r.new_zeros((D,))
        for b in self.batches:
            rows = []
            for s, g in enumerate(b.groups):
                d = layout.dims[g]
                base = layout.offsets[g] + b.idx[:, s] * d
                rows.append(base[:, None]
                            + torch.arange(d, device=r.device))  # [K, d]
            for s in range(len(b.groups)):
                gvec.index_put_(
                    (rows[s],),
                    b.sign * torch.einsum("kij,ki->kj", b.Js[s], b.r),
                    accumulate=True)
                for t in range(len(b.groups)):
                    H.index_put_(
                        (rows[s][:, :, None], rows[t][:, None, :]),
                        b.sign * torch.einsum("kij,kil->kjl", b.Js[s],
                                              b.Js[t]),
                        accumulate=True)
        return H, gvec


def linearize_batch(batch, values: Values) -> LinearBatch:
    """One vmap over the K factors of a batch: the residual and every slot's
    Jacobian by `jacfwd` through the retraction, then whitening (and the
    IRLS weights of a robust model)."""
    ms = [manifolds.get(g) for g in batch.groups]
    pts = batch.gather_points(values)
    zeros = tuple(pts[0].new_zeros((m.dim,)) for m in ms)

    def res_local(deltas, points, meas):
        xs = tuple(m.retract(p, d) for m, p, d in zip(ms, points, deltas))
        r = batch.residual_fn(xs, meas)
        return r, r

    def one(points, meas):
        Js, r = torch.func.jacfwd(res_local, argnums=0, has_aux=True)(
            zeros, points, meas)
        return r, Js

    with _JACFWD_LOCK:
        r, Js = torch.func.vmap(one)(pts, batch.meas)
    # Forward-mode tangents of a 0-dim tensor that meets a Python number
    # (`0.5 * w` on one element's angle) come out as float64 whatever the
    # primal's dtype: bring every Jacobian back to the residual's dtype.
    Js = tuple(J.to(r.dtype) for J in Js)
    rw, Jw = whiten_system(batch.noise, r, Js)
    return LinearBatch(batch.groups, batch.idx, Jw, rw, batch.sign)


def linearize(graph, values: Values) -> GaussianGraph:
    """Linearize the whole graph (reference:
    NonlinearFactorGraph::linearize)."""
    return GaussianGraph([linearize_batch(b, values) for b in graph.batches],
                         values.counts())
