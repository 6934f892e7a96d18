"""Pose-graph initialization: chordal relaxation for SE(3) and the LAGO-style
linear initialization for SE(2).

JAX counterpart: gtsam_personal_tpu/slam/initialize.py (all of it:
chordal_init :62, lago_init_2d :146, chordal_init_f64 :194; reference:
gtsam/slam/InitializePose3.h:36-91 and slam/lago.h:81-89). Rotations first:
R_j ~= R_i R_ij relaxed into linear least squares on the 9 entries of each
rotation, the solutions projected back onto SO(3) by SVD (Rot3::ClosestTo);
then positions, linear with the rotations fixed. In 2D the rotations are the
(cos, sin) vectors of the angles (the SO(2) chordal relaxation).

`chordal_init` and `lago_init_2d` run on the graph's device in its dtype:
each stage is a factor graph over a vector-space group ("rot9", "t3",
"rot2c", "t2", registered here) solved by one Gauss-Newton step through
linear/linearize.py and linear/solvers.py, densely for up to 6000 unknowns
and by PCG (tolerance 1e-10, 500 iterations) above. `chordal_init_f64` is the
host path: scipy sparse normal equations in float64 whatever the compute
dtype, the same sparse matrices as the JAX package's, built without its
per-edge Python loop.
"""

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Layout, Values
from gtsam_personal_tpu_torch.geometry import so3
from gtsam_personal_tpu_torch.linear import solvers
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.linear.noise import NoiseModel

manifolds.vector_space("rot9", 9)
manifolds.vector_space("t3", 3)
manifolds.vector_space("rot2c", 2)
manifolds.vector_space("t2", 2)


def _rot_residual(xs, meas):
    xi, xj = xs
    Rj = xj.unflatten(-1, (3, 3))
    Ri = xi.unflatten(-1, (3, 3))
    return (Rj - Ri @ meas["Rij"]).flatten(-2)


def _prior_residual(xs, meas):
    (x,) = xs
    return x - meas["prior"]


def _diff_residual(xs, meas):
    ti, tj = xs
    return tj - ti - meas["dt"]


def _rot2_residual(xs, meas):
    """c_j - R(theta_ij) c_i, c = (cos, sin) of the absolute angle."""
    ci, cj = xs
    c, s = meas["c"][..., None], meas["s"][..., None]
    return torch.cat([cj[..., 0:1] - (c * ci[..., 0:1] - s * ci[..., 1:2]),
                      cj[..., 1:2] - (s * ci[..., 0:1] + c * ci[..., 1:2])],
                     dim=-1)


def _solve_linear(graph: FactorGraph, initial: Values, use_pcg: bool):
    lin = linearize(graph, initial)
    if use_pcg:
        delta = solvers.solve_pcg(lin, lam=1e-8, maxiter=500, tol=1e-10)
    else:
        delta = solvers.solve_dense(lin, Layout.of(initial), lam=1e-10)
    return initial.retract(delta)


def _anchor(name, group, value, weight, like):
    """A prior on variable 0 of `group` at `value` with diagonal weight."""
    value = value.to(like)
    return FactorBatch(
        name, _prior_residual, (group,), value.shape[-1],
        torch.zeros((1, 1), dtype=torch.int64, device=like.device),
        {"prior": value[None]},
        NoiseModel("diag", torch.full((1, value.shape[-1]), weight,
                                      dtype=like.dtype, device=like.device)))


def _edges(graph: FactorGraph, name: str):
    """(idx [K, 2], measured [K, ...]) of the batches called `name`,
    concatenated, as tensors where the graph lives."""
    found = [(b.idx, b.meas["measured"]) for b in graph.batches
             if b.name == name]
    if not found:
        raise ValueError(f"no {name} factors found")
    return (torch.cat([f[0] for f in found]),
            torch.cat([f[1] for f in found]))


def chordal_init(graph: FactorGraph, num_poses: int, group: str = "se3",
                 use_pcg: bool = None) -> Values:
    """Initial SE(3) values from the `between_se3` measurements alone, pose
    0 anchored at the identity, on the graph's device and in its dtype."""
    if group != "se3":
        raise ValueError("chordal_init handles group 'se3'")
    ij, T = _edges(graph, "between_se3")
    n = num_poses
    if use_pcg is None:
        use_pcg = n * 9 > 6000
    eye9 = torch.eye(3, dtype=T.dtype, device=T.device).reshape(9)

    # ---- stage 1: rotations by chordal relaxation ----
    rot_between = FactorBatch("chordal_rot", _rot_residual, ("rot9", "rot9"),
                              9, ij, {"Rij": T[:, :, :3]}, NoiseModel("unit"))
    rot_graph = FactorGraph([_anchor("chordal_rot_prior", "rot9", eye9, 1e3,
                                     T), rot_between])
    rot_sol = _solve_linear(rot_graph,
                            Values({"rot9": eye9.expand(n, 9).clone()}),
                            use_pcg)
    # project onto SO(3) (reference: Rot3::ClosestTo in InitializePose3)
    R = so3.normalize(rot_sol["rot9"].reshape(n, 3, 3))

    # ---- stage 2: translations with the rotations fixed ----
    dt = torch.einsum("kij,kj->ki", R[ij[:, 0]], T[:, :, 3])
    t_graph = FactorGraph([
        _anchor("chordal_trans_prior", "t3", T.new_zeros(3), 1e3, T),
        FactorBatch("chordal_trans", _diff_residual, ("t3", "t3"), 3, ij,
                    {"dt": dt}, NoiseModel("unit"))])
    t_sol = _solve_linear(t_graph, Values({"t3": T.new_zeros((n, 3))}),
                          use_pcg)
    return Values({"se3": torch.cat([R, t_sol["t3"][:, :, None]], dim=2)})


def lago_init_2d(graph: FactorGraph, num_poses: int) -> Values:
    """Linear 2D pose-graph initialization (the chordal relaxation of the
    orientations, then linear positions) from the `between_se2` factors,
    pose 0 anchored, on the graph's device and in its dtype."""
    ij, m = _edges(graph, "between_se2")
    n = num_poses
    use_pcg = n * 2 > 6000
    e1 = m.new_tensor([1.0, 0.0])

    rot_graph = FactorGraph([
        _anchor("lago_rot_prior", "rot2c", e1, 1e3, m),
        FactorBatch("lago_rot", _rot2_residual, ("rot2c", "rot2c"), 2, ij,
                    {"c": torch.cos(m[:, 2]), "s": torch.sin(m[:, 2])},
                    NoiseModel("unit"))])
    cs = _solve_linear(rot_graph, Values({"rot2c": e1.expand(n, 2).clone()}),
                       use_pcg)["rot2c"]
    theta = torch.atan2(cs[:, 1], cs[:, 0])

    # positions with the orientations fixed
    ct, st = torch.cos(theta[ij[:, 0]]), torch.sin(theta[ij[:, 0]])
    dt = torch.stack([ct * m[:, 0] - st * m[:, 1],
                      st * m[:, 0] + ct * m[:, 1]], dim=1)
    t_graph = FactorGraph([
        _anchor("lago_t_prior", "t2", m.new_zeros(2), 1e3, m),
        FactorBatch("lago_t", _diff_residual, ("t2", "t2"), 2, ij,
                    {"dt": dt}, NoiseModel("unit"))])
    t = _solve_linear(t_graph, Values({"t2": m.new_zeros((n, 2))}),
                      use_pcg)["t2"]
    return Values({"se2": torch.cat([t, theta[:, None]], dim=1)})


def _solve_normal(rows, cols, vals, rhs, shape):
    """x = (A^T A + 1e-10 I)^-1 A^T rhs for the sparse A of (rows, cols,
    vals)."""
    A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
    AtA = (A.T @ A).tocsc() + 1e-10 * sp.eye(shape[1])
    return spla.spsolve(AtA, A.T @ rhs)


def chordal_init_f64(graph: FactorGraph, num_poses: int,
                     group: str = "se3", *, device, dtype) -> Values:
    """Host-side float64 chordal initialization (scipy sparse normal
    equations), whatever the compute dtype; the result is moved to `device`
    in `dtype`.

    The JAX package measured why (PERFORMANCE.md round 3, on sphere2500):
    from the float32 chordal point LM lands in a worse basin. Rotations:
    x_j - (I_3 (x) R_ij^T) x_i over the row-major vec of each rotation, and
    x_0 = vec(I) with weight 1e3; translations t_j - t_i = R_i dt_ij, and
    t_0 = 0 with weight 1e3 (reference: slam/InitializePose3.h:36-91). The
    triplets are those of the JAX package's loop, in its order."""
    if group != "se3":
        raise ValueError("chordal_init_f64 handles group 'se3'")
    ij, T = _edges(graph, "between_se3")
    ij = ij.cpu().numpy()
    T = T.detach().cpu().double().numpy()
    n, K = num_poses, ij.shape[0]
    i, j = ij[:, 0], ij[:, 1]
    k = np.arange(K)

    # ---- rotations: per edge 9 entries of +1 on x_j, then for each
    # (r, c) the three -R_ij[kk, c] on x_i[3 r + kk] ----
    base = np.arange(9)
    r_, c_, kk_ = np.meshgrid(np.arange(3), np.arange(3), np.arange(3),
                              indexing="ij")
    r_, c_, kk_ = r_.ravel(), c_.ravel(), kk_.ravel()
    rows = np.concatenate([9 * k[:, None] + base,
                           9 * k[:, None] + 3 * r_ + c_], axis=1)
    cols = np.concatenate([9 * j[:, None] + base,
                           9 * i[:, None] + 3 * r_ + kk_], axis=1)
    vals = np.concatenate([np.ones((K, 9)), -T[:, kk_, c_]], axis=1)
    rows = np.concatenate([rows.ravel(), 9 * K + base])
    cols = np.concatenate([cols.ravel(), base])
    vals = np.concatenate([vals.ravel(), 1e3 * np.ones(9)])
    b_vec = np.zeros(9 * K + 9)
    b_vec[9 * K + base] = 1e3 * np.eye(3).reshape(9)
    Rs = _solve_normal(rows, cols, vals, b_vec,
                       (9 * K + 9, 9 * n)).reshape(n, 3, 3)
    # project onto SO(3) (Rot3::ClosestTo), with the sign of det as the
    # JAX package's host path takes it
    U, _, Vt = np.linalg.svd(Rs)
    det = np.linalg.det(U @ Vt)
    Ufix = U.copy()
    Ufix[:, :, 2] *= np.sign(det)[:, None]
    R = Ufix @ Vt

    # ---- translations with the rotations fixed ----
    b3 = np.arange(3)
    rows = np.concatenate([3 * k[:, None] + b3, 3 * k[:, None] + b3], axis=1)
    cols = np.concatenate([3 * j[:, None] + b3, 3 * i[:, None] + b3], axis=1)
    vals = np.concatenate([np.ones((K, 3)), -np.ones((K, 3))], axis=1)
    rows = np.concatenate([rows.ravel(), 3 * K + b3])
    cols = np.concatenate([cols.ravel(), b3])
    vals = np.concatenate([vals.ravel(), 1e3 * np.ones(3)])
    rhs = np.zeros(3 * K + 3)
    rhs[:3 * K] = np.einsum("kij,kj->ki", R[i], T[:, :, 3]).ravel()
    t = _solve_normal(rows, cols, vals, rhs, (3 * K + 3, 3 * n)).reshape(n, 3)

    poses = np.concatenate([R, t[:, :, None]], axis=2)
    return Values({"se3": torch.tensor(poses, device=device, dtype=dtype)})
