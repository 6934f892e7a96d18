"""Plain reference of the pose-graph path: Levenberg-Marquardt on an SE(2)
pose graph with a prior on pose 0, as nonlinear.optimizers.lm_run defines
it with an exact solve.

Residuals: a between edge (i, j) with measurement z gives
Log(z^-1 * x_i^-1 * x_j), the prior gives Log(prior^-1 * x_0), each
whitened by 1 / sigma. One LM try: linearize (only after an accepted try),
solve (J^T J + lambda I) d = -J^T r exactly by a dense Cholesky
factorization of the whole system, retract x * Exp(d), and accept if the
error fell: lambda / 10 (floor 1e-10) on an accept, lambda * 10 (cap 1e5)
on a reject. A system that is not positive definite gives a non-finite
step, which is rejected. Jacobians by forward-mode differentiation of the
residuals; `rnd`, when given, rounds every operand of every product
(lie.einsum), the rotations of the residuals included: the lower-precision
control.
"""

import torch

from portbench.reference import lie


def _rot(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def _local(a, b, rnd=None):
    """Log(a^-1 * b) of [..., 3] poses: R_a^T (t_b - t_a) as a product."""
    d = lie.einsum("...ji,...j->...i", _rot(a[..., 2]), b[..., :2] - a[..., :2],
                   rnd=rnd)
    return lie.se2_log(torch.cat([d, b[..., 2:] - a[..., 2:]], -1))


def _between(xi, xj, z, rnd=None):
    """Log(z^-1 * xi^-1 * xj)."""
    d = lie.einsum("...ji,...j->...i", _rot(xi[..., 2]),
                   xj[..., :2] - xi[..., :2], rnd=rnd)
    rel = torch.cat([d, xj[..., 2:] - xi[..., 2:]], -1)
    return _local(z, rel, rnd)


def residuals(x, g, rnd=None):
    """Whitened (between [K, 3], prior [3])."""
    rb = _between(x[g["ij"][:, 0]], x[g["ij"][:, 1]], g["measured"], rnd) \
        * g["w"]
    return rb, _local(g["prior"], x[0], rnd) * g["w_prior"]


def error(x, g, rnd=None):
    rb, rp = residuals(x, g, rnd)
    return 0.5 * ((rb * rb).sum() + (rp * rp).sum())


def _edge(di, dj, xi, xj, z, w):
    return _between(lie.se2_retract(xi, di), lie.se2_retract(xj, dj), z) * w


def _prior(d, x, prior, w):
    return _local(prior, lie.se2_retract(x, d)) * w


def normal_equations(x, g, rnd=None):
    """(H [3N, 3N], grad [3N]) of J^T J and J^T r."""
    N = x.shape[0]
    i, j = g["ij"][:, 0], g["ij"][:, 1]
    K = i.shape[0]
    d0 = x.new_zeros(K, 3)
    w = g["w"].expand(K, 3)
    jac = torch.func.vmap(torch.func.jacfwd(_edge, argnums=(0, 1)))
    Ji, Jj = jac(d0, d0, x[i], x[j], g["measured"], w)
    Jp = torch.func.jacfwd(_prior)(x.new_zeros(3), x[0], g["prior"],
                                   g["w_prior"])
    r, rp = residuals(x, g, rnd)
    mm = lambda eq, *a: lie.einsum(eq, *a, rnd=rnd)   # noqa: E731
    H = x.new_zeros(3 * N, 3 * N)
    ar = torch.arange(3, device=x.device)

    def add(a, b, blocks):          # H[3a:3a+3, 3b:3b+3] += blocks
        rows = (3 * a)[:, None, None] + ar[None, :, None]
        cols = (3 * b)[:, None, None] + ar[None, None, :]
        H.view(-1).index_add_(0, (rows * 3 * N + cols).reshape(-1),
                              blocks.reshape(-1))

    add(i, i, mm("kri,krj->kij", Ji, Ji))
    add(j, j, mm("kri,krj->kij", Jj, Jj))
    add(i, j, mm("kri,krj->kij", Ji, Jj))
    add(j, i, mm("kri,krj->kij", Jj, Ji))
    zero = torch.zeros(1, dtype=torch.int64, device=x.device)
    add(zero, zero, mm("ri,rj->ij", Jp, Jp)[None])
    grad = x.new_zeros(N, 3)
    grad.index_add_(0, i, mm("kri,kr->ki", Ji, r))
    grad.index_add_(0, j, mm("kri,kr->ki", Jj, r))
    grad[0] += mm("ri,r->i", Jp, rp)
    return H, grad.reshape(-1)


def solve(H, grad, lam):
    """d [N, 3] of (H + lam I) d = -grad, NaN where not positive definite."""
    A = H.clone()
    A.diagonal().add_(lam)
    L, info = torch.linalg.cholesky_ex(A)
    del A
    d = torch.cholesky_solve(-grad[:, None], L)[:, 0]
    if int(info) != 0:
        d = torch.full_like(d, float("nan"))
    return d.reshape(-1, 3)


def lm_run(x, g, lam, n_iters, lam_factor=10.0, lam_lo=1e-10, lam_hi=1e5,
           rnd=None):
    """(x, lam, err) after `n_iters` tries; lam and err as floats."""
    err = float(error(x, g, rnd))
    need = True
    for _ in range(n_iters):
        if need:
            H, grad = normal_equations(x, g, rnd)
        trial = lie.se2_retract(x, solve(H, grad, lam))
        e = float(error(trial, g, rnd))
        need = e == e and e < err
        if need:
            x, err, lam = trial, e, max(lam / lam_factor, lam_lo)
        else:
            lam = min(lam * lam_factor, lam_hi)
    return x, lam, err
