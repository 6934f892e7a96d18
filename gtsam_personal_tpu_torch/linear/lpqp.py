"""LP and QP solvers (active-set method).

JAX counterpart: gtsam_personal_tpu/linear/lpqp.py (all of it; reference:
gtsam_unstable/linear/LPSolver and QPSolver, the active-set method with
linear equality and inequality constraints).

  QP:  min 0.5 x^T G x + g^T x   s.t.  A_eq x = b_eq,  A_in x <= b_in
  LP:  min c^T x                 s.t.  the same constraints (G = 0 taken
                                       with a tiny regularization for the
                                       KKT solve)

This module runs on the host in float64 numpy, as the JAX package's does,
and takes tensors (on any device) or arrays. An active-set iteration is a
sequence of small dense KKT solves, each of which decides the next working
set on the host from its result: on a card every iteration would cost a
round trip for a few microseconds of arithmetic, and the problems it is
used on (the reference's QPS tests) have a handful of variables.
"""

from typing import NamedTuple

import numpy as np
import torch


class QPResult(NamedTuple):
    x: np.ndarray
    active: np.ndarray
    iterations: int
    converged: bool


def _host(a):
    """A tensor (on any device) or an array as a float64 numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def solve_qp(G, g, A_eq=None, b_eq=None, A_in=None, b_in=None, x0=None,
             max_iter=100, tol=1e-9) -> QPResult:
    g = _host(g)
    n = len(g)
    G = _host(G)
    A_eq = np.zeros((0, n)) if A_eq is None else _host(A_eq)
    b_eq = np.zeros(0) if b_eq is None else _host(b_eq)
    A_in = np.zeros((0, n)) if A_in is None else _host(A_in)
    b_in = np.zeros(0) if b_in is None else _host(b_in)
    m_in = A_in.shape[0]

    # a feasible start: phase 1 by least squares unless given
    x = _phase1(A_eq, b_eq, A_in, b_in, n) if x0 is None else _host(x0)
    active = np.zeros(m_in, dtype=bool)
    if m_in:                          # start with the tight constraints
        active |= A_in @ x >= b_in - 1e-10

    for it in range(max_iter):
        # the equality-constrained QP on the working set
        W = np.concatenate([A_eq, A_in[active]], axis=0)
        k = W.shape[0]
        KKT = np.block([[G + 1e-12 * np.eye(n), W.T],
                        [W, np.zeros((k, k))]])
        rhs = np.concatenate([-(G @ x + g), np.zeros(k)])
        try:
            sol = np.linalg.solve(KKT, rhs)
        except np.linalg.LinAlgError:
            sol = np.linalg.lstsq(KKT, rhs, rcond=None)[0]
        p, lam = sol[:n], sol[n:]

        if np.linalg.norm(p) < tol:
            # the multipliers of the active inequalities
            lam_in = lam[A_eq.shape[0]:]
            if lam_in.size == 0 or lam_in.min() >= -tol:
                return QPResult(x, active, it, True)
            # release the most negative multiplier
            active[np.where(active)[0][np.argmin(lam_in)]] = False
            continue

        # the step length to the nearest blocking inactive constraint
        alpha, blocking = 1.0, -1
        for i in np.where(~active)[0] if m_in else ():
            ai_p = A_in[i] @ p
            if ai_p > tol:
                a_max = (b_in[i] - A_in[i] @ x) / ai_p
                if a_max < alpha:
                    alpha, blocking = a_max, i
        x = x + alpha * p
        if blocking >= 0:
            active[blocking] = True
    return QPResult(x, active, max_iter, False)


def solve_lp(c, A_eq=None, b_eq=None, A_in=None, b_in=None,
             max_iter=200) -> QPResult:
    """LP by the QP machinery with a vanishing quadratic regularizer
    (reference: LPSolver uses the same active-set core)."""
    c = _host(c)
    return solve_qp(1e-9 * np.eye(len(c)), c, A_eq, b_eq, A_in, b_in,
                    max_iter=max_iter)


def _phase1(A_eq, b_eq, A_in, b_in, n):
    """A feasible point: the equalities' least-squares solution, then pushed
    inside the inequalities along the violated rows' normals (projected
    onto the equalities' null space)."""
    if A_eq.shape[0]:
        x = np.linalg.lstsq(A_eq, b_eq, rcond=None)[0]
    else:
        x = np.zeros(n)
    if A_in.shape[0] == 0 or (A_in @ x - b_in).max() <= 0:
        return x
    for _ in range(200):
        viol = A_in @ x - b_in
        bad = viol > 1e-12
        if not bad.any():
            break
        d = -A_in[bad].T @ (viol[bad] / (np.linalg.norm(A_in[bad], axis=1)
                                         ** 2 + 1e-12))
        if A_eq.shape[0]:
            d = d - A_eq.T @ np.linalg.solve(
                A_eq @ A_eq.T + 1e-12 * np.eye(A_eq.shape[0]), A_eq @ d)
        if np.linalg.norm(d) < 1e-15:
            break
        x = x + d
    return x
