"""Subgraph (spanning-tree) preconditioned conjugate gradient.

JAX counterpart: gtsam_personal_tpu/linear/subgraph.py (all of it;
reference: linear/SubgraphSolver.h:76 with SubgraphBuilder and
SubgraphPreconditioner): the factor graph is split into a spanning tree and
the loop residue; the tree system is solved directly and preconditions CG
on the whole system. Chain- and tree-dominated graphs are where block-Jacobi
PCG struggles and SPCG does not.

The tree system's normal equations are assembled densely and factored once
on the device (`cholesky_nan`: NaN where not positive definite), then
applied by `torch.cholesky_solve` at every CG iteration. Dense means D^2
entries: at D = 30000 (10000 SE(2) poses) that is 7.2 GB in float64.
"""

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.dsf import kruskal_mst
from gtsam_personal_tpu_torch.core.values import Layout, tree_scale
from gtsam_personal_tpu_torch.inference.partition import VarIndex
from gtsam_personal_tpu_torch.linear import solvers
from gtsam_personal_tpu_torch.linear.linearize import (GaussianGraph,
                                                       LinearBatch)
from gtsam_personal_tpu_torch.linear.solvers import cholesky_nan


def build_spanning_tree_selection(graph_batches, counts):
    """Host-side: a spanning tree over the binary factors, structure only
    (uniform weights; the reference's SubgraphBuilder offers the same
    KRUSKAL choice). Returns per-batch boolean row masks [K] that select
    the tree's factors and every factor that is not binary."""
    vi = VarIndex(counts)
    edges, where = [], []
    for bi, b in enumerate(graph_batches):
        if len(b.groups) == 2:
            idx = b.idx.detach().cpu().numpy()
            i = vi.vid(b.groups[0], idx[:, 0])
            j = vi.vid(b.groups[1], idx[:, 1])
            edges.extend(zip(i.tolist(), j.tolist()))
            where.extend((bi, k) for k in range(idx.shape[0]))
    chosen = kruskal_mst(vi.num_vars, edges, np.ones(len(edges)))
    masks = [np.full(b.idx.shape[0], len(b.groups) != 2)
             for b in graph_batches]
    for k in chosen:
        bi, row = where[k]
        masks[bi][row] = True
    return masks


class SubgraphPreconditioner:
    """The tree subsystem factored densely once; `apply` is M^{-1} r."""

    def __init__(self, lin: GaussianGraph, masks, layout: Layout, lam=0.0):
        tree_batches = []
        for b, m in zip(lin.batches, masks):
            sel = torch.as_tensor(np.where(m)[0], device=b.r.device)
            tree_batches.append(LinearBatch(
                b.groups, b.idx[sel], tuple(J[sel] for J in b.Js), b.r[sel]))
        H, _ = GaussianGraph(tree_batches, lin.counts).assemble_dense(layout)
        H.diagonal().add_(lam + 1e-8)
        self.chol = cholesky_nan(H)
        self.layout = layout

    def apply(self, r):
        flat = self.layout.flatten(r)
        return self.layout.unflatten(
            torch.cholesky_solve(flat[:, None], self.chol)[:, 0])


def solve_spcg(lin: GaussianGraph, masks, layout: Layout, lam=0.0,
               maxiter=200, tol=1e-8):
    """Subgraph-preconditioned CG solve of the damped normal equations."""
    precond = SubgraphPreconditioner(lin, masks, layout, lam)
    b = tree_scale(lin.gradient_at_zero(), -1.0)
    matvec = solvers.make_damped_matvec(lin, lam, None)
    return solvers.pcg(matvec, b, precond.apply, maxiter=maxiter, tol=tol)
