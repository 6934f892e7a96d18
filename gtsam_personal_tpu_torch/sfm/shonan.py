"""Shonan rotation averaging: certifiably correct SO(3) synchronization by a
Riemannian staircase on SO(p).

JAX counterpart: gtsam_personal_tpu/sfm/shonan.py (all of it; reference:
sfm/ShonanAveraging.{h,cpp}):
  run(pMin..pMax)        -> shonan_averaging() (ShonanAveraging.h:404)
  tryOptimizingAt(p)     -> optimize_at()      (:351, LM on SO(p) values)
  computeMinEigenValue   -> min_eigenvalue()   (:253, accelerated power
                            method on the certificate matrix S = L - Lambda)

Each level p is an ordinary manifold ("sop<p>") with the Cayley retraction,
so a level is the package's batched LM; the certificate's matvec is two
`index_add_` over the edges, no sparse matrix is formed. The power method
runs as a loop of such matvecs on the device; the staircase's lifts, the
chordal start (scipy's `eigsh`) and the projections back to SO(3) run on
the host in numpy, with the same `default_rng(seed)` draws as the JAX
package, so both lift to the same numbers.
"""

import time
from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.geometry.son import solve_small
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers


# ---------------------------------------------------------------------------
# SO(p) manifold with the Cayley retraction
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _skew_basis(p: int, dtype, device) -> torch.Tensor:
    """[d, p, p]: +1 at the k-th upper-triangle entry (row-major order),
    -1 at its mirror."""
    iu = np.triu_indices(p, 1)
    E = np.zeros((len(iu[0]), p, p))
    k = np.arange(len(iu[0]))
    E[k, iu[0], iu[1]] = 1.0
    E[k, iu[1], iu[0]] = -1.0
    return torch.as_tensor(E, dtype=dtype, device=device)


def _skew_from_vec(xi, p):
    return torch.einsum("...k,kij->...ij", xi,
                        _skew_basis(p, xi.dtype, xi.device))


def _vec_from_skew(W, p):
    iu = np.triu_indices(p, 1)
    return W[..., iu[0], iu[1]]


def make_sop_manifold(p: int):
    name = f"sop{p}"
    try:
        return manifolds.get(name)
    except KeyError:
        pass

    def retract(R, xi):
        W = _skew_from_vec(0.5 * xi, p)
        eye = torch.eye(p, dtype=R.dtype, device=R.device)
        return R @ solve_small(eye - W, eye + W)        # Cayley transform

    def local(a, b):
        C = a.transpose(-1, -2) @ b
        eye = torch.eye(p, dtype=a.dtype, device=a.device)
        W = 2.0 * solve_small(C + eye, C - eye)
        return _vec_from_skew(0.5 * (W - W.transpose(-1, -2)), p)

    m = manifolds.Manifold(
        name, p * (p - 1) // 2, (p, p), retract, local,
        lambda *, device, dtype: torch.eye(p, device=device, dtype=dtype))
    return manifolds.register(m)


# ---------------------------------------------------------------------------
# Shonan factors at level p
# ---------------------------------------------------------------------------

def _shonan_residual(p: int):
    def residual(xs, meas):
        Yi, Yj = xs
        return (Yj - Yi @ meas["R_lift"]).reshape(p * p)
    residual.__name__ = f"shonan_p{p}"
    return residual


def _anchor_residual(p: int):
    def residual(xs, meas):
        (Y,) = xs
        return (Y - meas["target"]).reshape(p * p)
    residual.__name__ = f"shonan_anchor_p{p}"
    return residual


def build_graph_at(p: int, edges_ij: np.ndarray, R_meas: np.ndarray,
                   kappa: np.ndarray, *, device, dtype) -> FactorGraph:
    """buildGraphAt: Frobenius factors on SO(p) and a gauge prior."""
    make_sop_manifold(p)
    dev = config.device(device)
    K = edges_ij.shape[0]
    lifted = np.tile(np.eye(p), (K, 1, 1))
    lifted[:, :3, :3] = R_meas
    sqrtk = np.sqrt(kappa)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    batch = FactorBatch(
        f"shonan_p{p}", _shonan_residual(p), (f"sop{p}", f"sop{p}"), p * p,
        torch.as_tensor(np.asarray(edges_ij, dtype=np.int64), device=dev),
        {"R_lift": t(lifted)},
        NoiseModel("diag", t(np.repeat(sqrtk[:, None], p * p, axis=1))))
    anchor = FactorBatch(
        f"shonan_anchor_p{p}", _anchor_residual(p), (f"sop{p}",), p * p,
        torch.zeros((1, 1), dtype=torch.int64, device=dev),
        {"target": t(np.eye(p)[None])},
        NoiseModel("diag", t(np.full((1, p * p), 10.0))))
    return FactorGraph([anchor, batch])


def optimize_at(p: int, edges_ij, R_meas, kappa, Y_init,
                params: Optional[optimizers.Params] = None, *, device,
                dtype=torch.float64):
    """tryOptimizingAt: LM on the lifted problem at level p; returns (Y as
    numpy [n, p, p], Result)."""
    graph = build_graph_at(p, edges_ij, R_meas, kappa, device=device,
                           dtype=dtype)
    values = Values({f"sop{p}": torch.as_tensor(
        np.asarray(Y_init), dtype=dtype, device=config.device(device))})
    params = params or optimizers.Params(solver="pcg", pcg_maxiter=400,
                                         max_iterations=40)
    res = optimizers.optimize_lm(graph, values, params)
    return res.values[f"sop{p}"].cpu().numpy(), res


# ---------------------------------------------------------------------------
# Optimality certificate
# ---------------------------------------------------------------------------

def _laplacian_operator(edges_ij, R_meas, kappa, n):
    """V [n, 3, k] -> L V with the connection Laplacian L_ii = sum_j kappa
    I, L_ij = -kappa R_ij (edge i->j measuring R_ij); the degrees are
    summed once."""
    i, j = edges_ij[:, 0], edges_ij[:, 1]
    deg = torch.zeros((n,), dtype=kappa.dtype, device=kappa.device)
    deg.index_add_(0, i, kappa).index_add_(0, j, kappa)
    Rt = R_meas.transpose(-1, -2)
    kap = kappa[:, None, None]

    def apply(V):
        out = deg[:, None, None] * V
        out.index_add_(0, i, -kap * (R_meas @ V[j]))      # R_ij V_j
        out.index_add_(0, j, -kap * (Rt @ V[i]))          # R_ij^T V_i
        return out

    return apply, deg


def _connection_laplacian_matvec(edges_ij, R_meas, kappa, V):
    """V: [n, 3, k] block vector -> (L V)."""
    return _laplacian_operator(edges_ij, R_meas, kappa, V.shape[0])[0](V)


def _tensor(a):
    """A tensor of an array of any source (a tensor stays as it is)."""
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.array(a))


def min_eigenvalue(edges_ij, R_meas, kappa, Y, iters: int = 400,
                   seed: int = 0, accelerated: bool = True, *,
                   v0=None, device="cuda",
                   dtype=torch.float64) -> Tuple[float, np.ndarray]:
    """Minimum eigenvalue of the certificate matrix S = L - Lambda(Y) by a
    shifted power method on A = sigma I - S (reference:
    linear/AcceleratedPowerMethod.h, as ShonanAveraging's
    computeMinEigenValue uses it, sfm/ShonanAveraging.h:253).

    With `accelerated` (default), the momentum recurrence
    x_{k+1} = A x_k - beta x_{k-1} with beta = (rho/2)^2, rho from a short
    plain-power burn-in (the reference's estimated-beta scheme).

    v0 [n, 3] is the start vector (any array); without it the start is a
    standard normal draw from a CPU `torch.Generator` seeded with `seed`
    (the JAX package draws from `jax.random.PRNGKey(seed)`, which torch
    cannot reproduce: pass that draw as v0 to match it). sigma is read on
    the host as in the JAX package; rho and beta stay on the device.
    Returns (lambda_min, the last iterate as numpy [n, 3])."""
    dev = config.device(device)
    edges_ij = _tensor(edges_ij).to(dev, torch.int64)
    R_meas, kappa, Y = (_tensor(a).to(dev, dtype) for a in (R_meas, kappa,
                                                            Y))
    n = Y.shape[0]
    Z = Y.transpose(1, 2)                                # [n, 3, p]
    L, deg = _laplacian_operator(edges_ij, R_meas, kappa, n)

    # Lambda_i = sym((L Z)_i Z_i^T)
    Lam = torch.einsum("nip,njp->nij", L(Z), Z)
    Lam = 0.5 * (Lam + Lam.transpose(1, 2))              # [n, 3, 3]

    # shift: sigma >= lambda_max(S) by a Gershgorin-style bound
    sigma = 2.0 * float(deg.max()) + float(Lam.abs().max()) * 3 + 1.0

    def A(u):                                            # sigma I - S
        Su = L(u[:, :, None])[:, :, 0] - (Lam @ u[:, :, None])[:, :, 0]
        return sigma * u - Su

    if v0 is None:
        v0 = torch.randn((n, 3), generator=torch.Generator().manual_seed(
            seed), dtype=dtype)
    v = _tensor(v0).to(dev, dtype)
    v = v / torch.linalg.norm(v)

    def step(v):
        w = A(v)
        return w / torch.clamp(torch.linalg.norm(w), min=1e-30)

    if not accelerated:
        for _ in range(iters):
            v = step(v)
    else:
        burn = min(10, iters)
        for _ in range(burn):
            v = step(v)
        rho = (v * A(v)).sum()                           # Rayleigh estimate
        beta = (rho / 2.0) ** 2
        v_prev = torch.zeros_like(v)
        for _ in range(max(iters - burn, 0)):
            w = A(v) - beta * v_prev
            nrm = torch.clamp(torch.linalg.norm(w), min=1e-30)
            v, v_prev = w / nrm, v / nrm
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)

    lam_shift = float((v * A(v)).sum())
    return sigma - lam_shift, v.cpu().numpy()


# ---------------------------------------------------------------------------
# Staircase driver
# ---------------------------------------------------------------------------

class ShonanResult(NamedTuple):
    rotations: np.ndarray     # [n, 3, 3]
    certified: bool
    p_final: int
    min_eig: float
    cost: float


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def shonan_averaging(edges_ij: np.ndarray, R_meas: np.ndarray,
                     kappa: Optional[np.ndarray] = None,
                     p_min: int = 3, p_max: int = 7,
                     optimality_threshold: float = -1e-4,
                     init: Optional[np.ndarray] = None,
                     seed: int = 0, *, v0=None, device="cuda",
                     dtype=torch.float64,
                     on_level: Optional[Callable] = None) -> ShonanResult:
    """run(): the staircase p_min..p_max with certification.

    v0 is min_eigenvalue's start vector at every level (the JAX package
    starts every level from the same PRNGKey(0) draw). `on_level`, if
    given, is called after each level with a dict: p, the LM Result and
    its seconds ('lm_s'), min_eig and its seconds ('eig_s'); the seconds
    are between device synchronizations."""
    dev = config.device(device)
    n = int(edges_ij.max()) + 1
    K = edges_ij.shape[0]
    kappa = np.ones(K) if kappa is None else np.asarray(kappa)

    if init is None:
        init = _chordal_rotations(edges_ij, R_meas, n)

    Y = init                                             # [n, 3, 3]
    rng = np.random.default_rng(seed)
    res = None
    for p in range(p_min, p_max + 1):
        if Y.shape[1] < p:
            pad = np.zeros((n, p - Y.shape[1], Y.shape[2]))
            Y = np.concatenate([Y, pad], axis=1)         # lift rows
        if Y.shape[2] < p:
            # lift to p x p orthogonal: extend the columns by Gram-Schmidt
            Y = _orthonormal_complete(Y, p, rng)
        _sync(dev)
        t0 = time.perf_counter()
        Yp, res = optimize_at(p, edges_ij, R_meas, kappa, Y, device=dev,
                              dtype=dtype)
        t1 = time.perf_counter()
        lam, _ = min_eigenvalue(edges_ij, R_meas, kappa, Yp[:, :, :3],
                                v0=v0, device=dev, dtype=dtype)
        t2 = time.perf_counter()
        if on_level is not None:
            on_level({"p": p, "result": res, "lm_s": t1 - t0,
                      "min_eig": lam, "eig_s": t2 - t1})
        if lam >= optimality_threshold:
            return ShonanResult(_project_to_so3(Yp), True, p, lam,
                                res.error)
        # descend along the certificate eigenvector; continue the staircase
        Y = Yp + 1e-2 * rng.standard_normal(Yp.shape)
        Y = np.stack([_nearest_orthogonal(Yk) for Yk in Y])
    return ShonanResult(_project_to_so3(Yp), False, p_max, lam, res.error)


def _rotation_laplacian(edges_ij, R_meas, n):
    """The rotation graph's connection Laplacian [3n, 3n] (scipy CSR), with
    1e-3 added on pose 0's diagonal: block (i, j) is -R_ij for an edge i->j
    and its transpose at (j, i)."""
    import scipy.sparse as sp
    edges_ij = np.asarray(edges_ij)
    i, j = edges_ij[:, 0], edges_ij[:, 1]
    a, b = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    # per edge and (a, b): the entry (3i+a, 3j+b) then its mirror, in the
    # order the JAX package appends them
    r1 = 3 * i[:, None, None] + a
    c1 = 3 * j[:, None, None] + b
    v = -np.asarray(R_meas)
    rows = np.stack([r1, c1], -1).ravel()
    cols = np.stack([c1, r1], -1).ravel()
    vals = np.stack([v, v], -1).ravel()
    deg = np.zeros(n)
    np.add.at(deg, i, 1.0)
    np.add.at(deg, j, 1.0)
    dg = np.repeat(deg, 3)
    dg[:3] += 1e-3
    rows = np.concatenate([rows, np.arange(3 * n)])
    cols = np.concatenate([cols, np.arange(3 * n)])
    vals = np.concatenate([vals, dg])
    return sp.csr_matrix((vals, (rows, cols)), shape=(3 * n, 3 * n))


def _chordal_rotations(edges_ij, R_meas, n):
    """The JAX package's start: the three eigenvectors of the rotation
    Laplacian nearest to zero (scipy's eigsh, on the host), each 3 x 3
    block projected to SO(3). Copied with two faults of the reference
    (ROADMAP queue 3 C11): eigsh starts ARPACK from a hidden seed that moves
    on with every call, so the eigenvectors' signs, and with a reflection
    the start itself, change from call to call; and the blocks are the
    transposes of the rotations in the convention of the levels' variables
    (Y_j = Y_i R_ij). `chordal_start` is the start without them."""
    import scipy.sparse.linalg as spla
    _, V = spla.eigsh(_rotation_laplacian(edges_ij, R_meas, n), k=3,
                      sigma=-1e-3, which="LM")
    return np.stack([_nearest_rotation(blk) for blk in V.reshape(n, 3, 3)])


def chordal_start(edges_ij, R_meas, n):
    """The chordal start in the levels' convention, the same every call:
    `_chordal_rotations`' eigenvectors from a fixed ARPACK start vector
    (ones), their signs taken so that the blocks have a positive median
    determinant (no reflection), each block projected to SO(3) and
    transposed. Opt-in: `shonan_averaging` without `init` takes the JAX
    package's start."""
    import scipy.sparse.linalg as spla
    _, V = spla.eigsh(_rotation_laplacian(edges_ij, R_meas, n), k=3,
                      sigma=-1e-3, which="LM", v0=np.ones(3 * n))
    blocks = V.reshape(n, 3, 3)
    if np.median(np.linalg.det(blocks)) < 0:
        blocks = blocks * np.array([-1.0, 1.0, 1.0])
    return np.stack([_nearest_rotation(blk).T for blk in blocks])


def _nearest_rotation(M):
    u, _, vt = np.linalg.svd(M)
    d = np.sign(np.linalg.det(u @ vt))
    return u @ np.diag([1.0, 1.0, d]) @ vt


def _nearest_orthogonal(M):
    u, _, vt = np.linalg.svd(M, full_matrices=False)
    return u @ vt


def _orthonormal_complete(Y, p, rng):
    """Extend [n, p, c] (c < p) blocks to [n, p, p] with orthonormal
    columns."""
    n, rows, c = Y.shape
    out = np.zeros((n, p, p))
    for k in range(n):
        Q, _ = np.linalg.qr(np.concatenate(
            [Y[k], rng.standard_normal((rows, p - c))], axis=1))
        # keep the original columns' orientation
        for col in range(c):
            if np.dot(Q[:, col], Y[k][:, col]) < 0:
                Q[:, col] *= -1
        out[k] = Q
        if np.linalg.det(Q) < 0:
            out[k][:, -1] *= -1
    return out


def _project_to_so3(Yp):
    """Project the [n, p, p] staircase solution to SO(3): the 3 leading
    columns' p x 3 blocks, aligned globally (reference: roundSolution)."""
    blocks = Yp[:, :, :3]                                 # [n, p, 3]
    n, p, _ = blocks.shape
    # best rank-3 row space across all blocks
    stacked = blocks.transpose(1, 0, 2).reshape(p, 3 * n)
    u, s, vt = np.linalg.svd(stacked, full_matrices=False)
    A = u[:, :3].T                                        # [3, p]
    R = np.einsum("ap,npb->nab", A, blocks)
    # the basis has a sign ambiguity: take the orientation that makes the
    # blocks proper rotations (det +1), else the per-block projection would
    # reflect them inconsistently
    if np.median(np.linalg.det(R)) < 0:
        A[0] *= -1.0
        R = np.einsum("ap,npb->nab", A, blocks)
    Rs = np.stack([_nearest_rotation(Rk) for Rk in R])
    # gauge: left-multiply by Rs[0]^T so that R_0 = I
    return np.stack([Rs[0].T @ Rk for Rk in Rs])
