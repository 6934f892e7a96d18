"""Linear solvers for the Gauss-Newton system
(J^T J + damping) delta = -J^T r.

JAX counterpart: gtsam_personal_tpu/linear/solvers.py (all of it; reference:
GaussianFactorGraph::optimizeDensely and linear/PCGSolver.h:55).

- `solve_dense` assembles the full normal equations and factorizes them.
- `solve_pcg` is matrix-free preconditioned conjugate gradient with a
  block-Jacobi preconditioner.

Both take the damping (lambda, optionally scaled by diag(H)), so LM uses
them directly; lambda may be a float or a 0-dim tensor on the device.

A matrix that is not positive definite: `jnp.linalg.cholesky` returns NaN,
and the LM loop then sees a non-finite error and rejects the try.
`cholesky_nan` keeps that contract without a host read: it factors with
`torch.linalg.cholesky_ex(check_errors=False)` and puts NaN where `info > 0`.
"""

from typing import Dict, Optional

import torch

from gtsam_personal_tpu_torch.core.values import (Layout, tree_axpy,
                                                  tree_scale, tree_sub,
                                                  tree_vdot, tree_zeros_like)
from gtsam_personal_tpu_torch.linear.linearize import GaussianGraph

PCG_CHECK_EVERY = 8     # iterations between two reads of PCG's stop flag


def cholesky_nan(A):
    """Lower Cholesky factor of [..., n, n]; all-NaN for each matrix that is
    not positive definite (no exception, no host read)."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def solve_dense(lin: GaussianGraph, layout: Layout, lam=0.0,
                diag_damping: Optional[torch.Tensor] = None):
    """Solve (H + lam * D) delta = -g densely; D = I or
    diag(diag_damping) (a flat [total_dim] tensor)."""
    H, g = lin.assemble_dense(layout)
    damp = lam * (diag_damping if diag_damping is not None
                  else torch.ones_like(g))
    H.diagonal().add_(damp)
    delta = torch.cholesky_solve(-g[:, None], cholesky_nan(H))[:, 0]
    return layout.unflatten(delta)


def _block_jacobi_preconditioner(lin: GaussianGraph, lam, diag_damping,
                                 group=None):
    """The M^{-1} apply function from the per-variable (d, d) Hessian
    blocks, each damped and factored once. With `group`, `lin` is this
    rank's share of the factors and the blocks are summed over the ranks."""
    blocks = lin.hessian_block_diagonal()
    if group is not None:
        blocks = group.psum_tree(blocks)
    chol = {}
    for g, B in blocks.items():
        eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
        if diag_damping is not None:
            B = B + lam * torch.diag_embed(diag_damping[g])
        else:
            B = B + lam * eye
        chol[g] = cholesky_nan(B + 1e-10 * eye)

    def apply(r):
        return {g: torch.cholesky_solve(r[g][..., None], L)[..., 0]
                for g, L in chol.items()}

    return apply


def make_damped_matvec(lin: GaussianGraph, lam, diag_damping, group=None):
    """x -> (J^T J + lam D) x; with `group`, `lin` is this rank's share of
    the factors and J^T J x is summed over the ranks."""
    def matvec(x):
        hx = lin.hessian_vector_product(x)
        if group is not None:
            hx = group.psum_tree(hx)
        if diag_damping is not None:
            return {g: hx[g] + lam * diag_damping[g] * x[g] for g in hx}
        return {g: hx[g] + lam * x[g] for g in hx}
    return matvec


def pcg_loop(matvec, precond, x, r, threshold, maxiter):
    """The CG iterations from the iterate x with residual r = b - A x, until
    r.r <= threshold (a 0-dim tensor) or `maxiter`; returns (x, iterations
    used as a 0-dim int64 tensor).

    The JAX package stops in a `while_loop` at the first iteration whose
    residual is under the tolerance. Here every update is masked by that
    same test on the device, so an iteration past the stop changes nothing
    and is not counted, and the host reads the stop flag only every
    `PCG_CHECK_EVERY` iterations to leave the loop: the result and the count
    are those of an exact stop, at one host read per `PCG_CHECK_EVERY`
    iterations instead of one per iteration."""
    z = precond(r)
    p = z
    rz = tree_vdot(r, z)
    zero, one = torch.zeros_like(rz), torch.ones_like(rz)
    used = torch.zeros((), dtype=torch.int64, device=rz.device)

    for k in range(maxiter):
        active = tree_vdot(r, r) > threshold
        if k % PCG_CHECK_EVERY == 0 and not bool(active):
            break
        used = used + active
        Ap = matvec(p)
        pAp = tree_vdot(p, Ap)
        step = active & (pAp > 0)
        alpha = torch.where(step, rz / torch.where(pAp > 0, pAp, one), zero)
        x = tree_axpy(alpha, p, x)
        r = tree_axpy(-alpha, Ap, r)
        z = precond(r)
        rz_new = tree_vdot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, one)
        p = {g: torch.where(active, z[g] + beta * p[g], p[g]) for g in p}
        rz = torch.where(active, rz_new, rz)
    return x, used


def pcg(matvec, b: Dict[str, torch.Tensor], precond=None, maxiter=250,
        tol=1e-8, x0=None):
    """Preconditioned CG for A x = b over tangent dicts, with an iteration
    cap and a tolerance on the residual relative to |b|; `x0` warm-starts it
    (reference: the CG loop of linear/iterative-inl.h). See `pcg_loop` for
    how it stops."""
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x, r = tree_zeros_like(b), b            # b - A*0
    else:
        x, r = x0, tree_sub(b, matvec(x0))
    threshold = (tol * torch.sqrt(tree_vdot(b, b))) ** 2
    return pcg_loop(matvec, precond, x, r, threshold, maxiter)[0]


def solve_pcg(lin: GaussianGraph, lam=0.0, diag_damping=None,
              maxiter=250, tol=1e-8, group=None):
    """PCG solve of the (damped) normal equations with block-Jacobi
    preconditioning; returns the tangent-dict update delta.

    `group` (parallel/mesh.py:Mesh) solves a system whose factors are
    dealt over ranks, `lin` holding this rank's share (mesh.shard_graph):
    the gradient, every matvec and the preconditioner's blocks are summed
    over the ranks, one all-reduce each, and the CG vectors are the same on
    every rank (the explicit form of the JAX package's GSPMD step over a
    sharded graph). `diag_damping`, if given, is already the sum."""
    g = lin.gradient_at_zero()
    if group is not None:
        g = group.psum_tree(g)
    b = tree_scale(g, -1.0)
    matvec = make_damped_matvec(lin, lam, diag_damping, group)
    precond = _block_jacobi_preconditioner(lin, lam, diag_damping, group)
    return pcg(matvec, b, precond, maxiter=maxiter, tol=tol)
