"""Bundle adjustment: state, observations, and the camera-major engine.

JAX counterpart: gtsam_personal_tpu/sfm/ba.py (BAState, BAObservations,
state_from_bal, linearize_ba, ba_error, pcg, solve_ba_step,
linearize_ba_cm, solve_ba_step_cm, ba_error_cm, retract_ba, ba_try_step,
make_layout, optimize_ba; lines 38-583 but for the `_fm` variants, which
are a relayout for the TPU's tiles) and gtsam_personal_tpu/sfm/
ba_bucket.py:278-327 (_analytic_rJ).

Cameras follow the reference's PinholeCamera<Cal3Bundler> 9-dof manifold
(pose 6 + calibration 3); the camera tangent is [pose xi, dcal].
`state_from_numpy` / `observations_from_numpy` carry state across from any
array source (a `BalProblem`, or `np.asarray` of a JAX `BAState`).

The engine lifts the reference's implicit Schur complement
(slam/RegularImplicitSchurFactor.h, y += F'(I - E P E') F x) to the whole
problem, solved by PCG with an exact per-camera block-Jacobi
preconditioner of S, landmarks back-substituted in closed form. Every
observation is one row of feature-major [k, M] tensors over the rows of a
`sfm/ba_layout.py:BALayout` (observations sorted camera-major); camera and
landmark values reach a row by a gather, per-camera and per-landmark sums
are `index_add_` over `cam_of` / `pt_of`. The JAX package's dense Q/T slot
layout with its camera mask and tile permutations is not needed on a GPU.
sfm/ba_pack.py's LM runs on the same math with another schedule.

Linearization is analytic (`_analytic_rJ`), where the JAX camera-major
engine takes `jax.jacfwd` of the residual: the same function, held to it in
float64 by tests/test_torch_ba_cm.py. Its depth clamp (|z| >= 1e-8) acts
only on rows that the cheirality mask (depth > 1e-6) zeroes anyway, where
it keeps 0 * inf from making a NaN.

The landmark solves (right-hand side, every Schur matvec of the CG loop,
back-substitution) go through ops/block_solve.py:landmark_block_solve, the
hand-written CUDA kernel on the card and its plain version on the CPU.
"""

from typing import NamedTuple

import numpy as np
import torch

from gtsam_personal_tpu_torch import config  # noqa: F401  (TF32 off)
from gtsam_personal_tpu_torch.geometry import cameras as cam_geo, se3
from gtsam_personal_tpu_torch.linear.noise import robust_loss, robust_weight
from gtsam_personal_tpu_torch.ops.block_solve import landmark_block_solve
from gtsam_personal_tpu_torch.sfm import ba_kernels as bk
from gtsam_personal_tpu_torch.sfm.ba_layout import BALayout, build_layout
from gtsam_personal_tpu_torch.sfm.bal import BalProblem


class BAState(NamedTuple):
    cam_poses: torch.Tensor   # [C, 3, 4] camera-to-world
    cam_cals: torch.Tensor    # [C, 3]    Cal3Bundler (f, k1, k2)
    points: torch.Tensor      # [P, 3]


class BAObservations(NamedTuple):
    cam: torch.Tensor         # [M] int64
    point: torch.Tensor       # [M] int64
    uv: torch.Tensor          # [M, 2]


def state_from_numpy(cam_poses, cam_cals, points, *, device, dtype):
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return BAState(t(cam_poses), t(cam_cals), t(points))


def observations_from_numpy(cam, point, uv, *, device, dtype):
    def idx(a):
        return torch.tensor(np.asarray(a, dtype=np.int64), device=device)
    return BAObservations(idx(cam), idx(point),
                          torch.tensor(np.asarray(uv), dtype=dtype,
                                       device=device))


def state_to_numpy(state: BAState) -> BAState:
    """The same state as host numpy arrays (one device-to-host copy each)."""
    return BAState(*(x.detach().cpu().numpy() for x in state))


def state_from_bal(prob: BalProblem, *, device, dtype):
    """(BAState, BAObservations) of a BAL-shaped problem on `device`."""
    return (state_from_numpy(prob.cam_poses, prob.cam_cals, prob.points,
                             device=device, dtype=dtype),
            observations_from_numpy(prob.obs_cam, prob.obs_point,
                                    prob.obs_uv, device=device, dtype=dtype))


def _residual_one(pose, cal, point, uv):
    """Reprojection residual, batched over leading axes (reference:
    GeneralSFMFactor::evaluateError = camera.project(point) - measured)."""
    return cam_geo.project_point(pose, point, cal, "cal3bundler") - uv


def retract_ba(state: BAState, xc, xp) -> BAState:
    """Apply a step: camera poses by the right retraction, calibrations and
    points by addition. xc [C, 9] = [xi, dcal], xp [P, 3]."""
    return BAState(se3.retract(state.cam_poses, xc[:, :6]),
                   state.cam_cals + xc[:, 6:9], state.points + xp)


def make_layout(obs: BAObservations, C: int, P: int) -> BALayout:
    """Index plan of `obs` on its own device and dtype (one host copy of the
    observations, at set-up)."""
    return build_layout(obs.cam.cpu().numpy(), obs.point.cpu().numpy(),
                        obs.uv.cpu().numpy(), C, P, device=obs.uv.device,
                        dtype=obs.uv.dtype)


# ---------------------------------------------------------------------------
# residuals and Jacobians
# ---------------------------------------------------------------------------

def _analytic_rJ(posesT, calsT, pts_cm, uv_cm, eps=1e-8):
    """Closed-form reprojection residual and Jacobians per row.

    Chain (right retraction pose*Exp(xi), xi=(omega, v), Pose3.h:147):
      pc = R^T (p - t);  d pc/d omega = [pc]x,  d pc/d v = -I,  d pc/dp = R^T
      pn = (x/z, y/z);   d pn/d pc = 1/z [[1,0,-pn_x],[0,1,-pn_y]]
      uv = f g(r2) pn,   g = 1 + k1 r2 + k2 r2^2  (Cal3Bundler::uncalibrate)
    posesT [3, 4, M], calsT [3, M], pts_cm [3, M], uv_cm [2, M].
    Returns r [2, M], Jc [2, 9, M], Jp [2, 3, M], depth [M]."""
    R = posesT[:, :3]                         # [3, 3, M] (rows i, cols j)
    t = posesT[:, 3]                          # [3, M]
    f, k1, k2 = calsT[0], calsT[1], calsT[2]
    d = [pts_cm[j] - t[j] for j in range(3)]
    x, y, z = [R[0][i] * d[0] + R[1][i] * d[1] + R[2][i] * d[2]
               for i in range(3)]             # R^T d
    e = torch.full_like(z, eps)
    z_safe = torch.where(z.abs() < eps, torch.where(z < 0, -e, e), z)
    iz = 1.0 / z_safe
    nx, ny = x * iz, y * iz
    r2 = nx * nx + ny * ny
    g = 1.0 + r2 * (k1 + k2 * r2)
    G = f * g
    h = 2.0 * f * (k1 + 2.0 * k2 * r2)        # d(f g)/d r2 * 2
    A00 = G + h * nx * nx                     # A = d uv / d pn  [2x2]
    A01 = h * nx * ny
    A11 = G + h * ny * ny
    B = [[A00 * iz, A01 * iz, -(A00 * nx + A01 * ny) * iz],   # A d pn/d pc
         [A01 * iz, A11 * iz, -(A01 * nx + A11 * ny) * iz]]
    r = torch.stack([G * nx - uv_cm[0], G * ny - uv_cm[1]])
    Jc = torch.stack([torch.stack([
        Bi1 * z - Bi2 * y,                    # d/d omega_x  (B @ [pc]x)
        -Bi0 * z + Bi2 * x,                   # d/d omega_y
        Bi0 * y - Bi1 * x,                    # d/d omega_z
        -Bi0, -Bi1, -Bi2,                     # d/d v
        g * n,                                # d/d f
        f * r2 * n,                           # d/d k1
        f * r2 * r2 * n,                      # d/d k2
    ]) for (Bi0, Bi1, Bi2), n in zip(B, (nx, ny))])
    Jp = torch.stack([torch.stack([
        Bi[0] * R[k][0] + Bi[1] * R[k][1] + Bi[2] * R[k][2]
        for k in range(3)]) for Bi in B])     # B @ R^T
    return r, Jc, Jp, z


def _rows_rJ(state: BAState, cam, pt, uv_T, mask=True, robust="none",
             robust_k=1.0):
    """Residuals and Jacobians of the rows (cam [M], pt [M], uv_T [2, M]):
    r [2, M], Jc [2, 9, M], Jp [2, 3, M]. Rows behind the camera (depth <=
    1e-6) are zero when `mask`. robust != 'none' applies the IRLS
    sqrt-weight of the named m-estimator to each row (the reference's
    Robust::WhitenSystem, fixed-weight approximation, no Triggs
    correction)."""
    C = state.cam_poses.shape[0]
    posesT = state.cam_poses.reshape(C, 12).T[:, cam].reshape(3, 4, -1)
    r, Jc, Jp, depth = _analytic_rJ(posesT, state.cam_cals.T[:, cam],
                                    state.points.T[:, pt], uv_T)
    if not mask:
        return r, Jc, Jp
    w = (depth > 1e-6).to(r.dtype)
    if robust != "none":
        e = torch.sqrt(r[0] * r[0] + r[1] * r[1] + 1e-30)
        w = w * torch.sqrt(robust_weight(robust, e, robust_k))
    return r * w, Jc * w, Jp * w


def _rows_error(state: BAState, cam, pt, uv, mask=True, robust="none",
                robust_k=1.0):
    """Total error of the rows (uv [M, 2]) as a 0-d tensor: 0.5 sum |r|^2
    over rows in front of the camera, or sum rho(|r|) for a robust kind."""
    pose = state.cam_poses[cam]                           # [M, 3, 4]
    point = state.points[pt]                              # [M, 3]
    r = _residual_one(pose, state.cam_cals[cam], point, uv)
    w = (cam_geo.depth_of(pose, point) > 1e-6).to(r.dtype)
    if mask:
        r = r * w[:, None]
    if robust != "none":
        e = torch.sqrt(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1] + 1e-30)
        return (w * robust_loss(robust, e, robust_k)).sum()
    return 0.5 * (r * r).sum()


def linearize_ba(state: BAState, obs: BAObservations, mask_cheirality=True):
    """Residuals and Jacobians in observation order: r [M, 2], Jc [M, 18]
    (row-major 2x9), Jp [M, 6] (row-major 2x3)."""
    r, Jc, Jp = _rows_rJ(state, obs.cam, obs.point, obs.uv.T,
                         mask_cheirality)
    M = r.shape[1]
    return (r.T, Jc.permute(2, 0, 1).reshape(M, 18),
            Jp.permute(2, 0, 1).reshape(M, 6))


def ba_error(state: BAState, obs: BAObservations, mask_cheirality=True):
    """0.5 sum |r|^2 over the observations, a 0-d tensor."""
    return _rows_error(state, obs.cam, obs.point, obs.uv, mask_cheirality)


def linearize_ba_cm(state: BAState, obs: BAObservations, layout: BALayout):
    """The layout's rows (observations sorted camera-major): r [2, M],
    Jc [2, 9, M], Jp [2, 3, M], zero behind the camera. `obs` is carried
    for the JAX signature; the layout holds the measurements."""
    return _rows_rJ(state, layout.cam_of, layout.pt_of, layout.uv_cm)


def ba_error_cm(state: BAState, obs: BAObservations, layout: BALayout):
    """The total error summed over the layout's rows (same value as
    ba_error)."""
    return _rows_error(state, layout.cam_of, layout.pt_of, layout.uv_cm.T)


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------

def _cam_sum(pl: BALayout, x):
    """Per-camera sums of rows: [k, M] -> [k, C]."""
    return x.new_zeros(x.shape[0], pl.C).index_add_(1, pl.cam_of, x)


def _pt_sum(pl: BALayout, x):
    """Per-landmark sums of rows: [k, M] -> [k, P]."""
    return x.new_zeros(x.shape[0], pl.P).index_add_(1, pl.pt_of, x)


def _pcg(matvec, b, precond, maxiter, tol, check_every=None, side0=None,
         dist=None):
    """Preconditioned CG over tensors of any shape (vdot over all entries),
    with the JAX `pcg`'s guards: alpha = 0 on non-positive curvature, safe
    divisions. Returns (x, side, iterations) with `iterations` a 0-d device
    tensor.

    Updates are masked: an iteration changes the carry only while
    rr.rr > tol^2 b.b, so running on past convergence is a no-op and the
    result is that of the JAX while_loop with its tolerance exit. With
    `check_every` the loop reads that flag on the host before every
    `check_every`-th iteration and stops once it is false; without it the
    loop runs `maxiter` iterations and reads nothing.

    With `side0`, matvec(p) returns (A p, s(p)) for a linear s, and `side`
    accumulates sum alpha_k s(p_k) = s(x) (ba_pack's fused landmark
    back-substitution); otherwise matvec returns A p and side is None.

    `dist` (parallel/dist_ba.py:RankSums) makes every dot product a sum over
    the ranks, b holding this rank's cameras: one all-reduce a dot, as the
    JAX `psum` of each (parallel/dist_ba_pack.py:473 of the JAX package).
    Every rank then reads the same stop flag."""
    def dots(*pairs):
        sums = [(u * v).sum() for u, v in pairs]
        return sums if dist is None else dist.sums(sums)

    x = torch.zeros_like(b)
    rr = b
    z = precond(b)
    p = z
    rz, bb = dots((b, z), (b, b))
    thr = (tol ** 2) * bb
    side = side0
    iters = torch.zeros((), dtype=torch.int64, device=b.device)
    for k in range(maxiter):
        active = dots((rr, rr))[0] > thr
        if check_every and k % check_every == 0 and not bool(active):
            break
        out = matvec(p)
        Ap, sp = out if side0 is not None else (out, None)
        pAp, = dots((p, Ap))
        alpha = torch.where(pAp > 0, rz / torch.where(pAp != 0, pAp, 1.0),
                            0.0)
        rr_n = rr - alpha * Ap
        z = precond(rr_n)
        rz_n, = dots((rr_n, z))
        beta = rz_n / torch.where(rz != 0, rz, 1.0)
        x = torch.where(active, x + alpha * p, x)
        if side0 is not None:
            side = torch.where(active, side + alpha * sp, side)
        p = torch.where(active, z + beta * p, p)
        rr = torch.where(active, rr_n, rr)
        rz = torch.where(active, rz_n, rz)
        iters = iters + active.to(torch.int64)
    return x, side, iters


def pcg(matvec, b, precond, maxiter, tol, check_every=8):
    """Preconditioned CG (JAX: sfm/ba.py:pcg). Stops within `check_every`
    iterations of convergence (one host read of the flag per
    `check_every` iterations; None runs all `maxiter`, masked). Returns
    x."""
    return _pcg(matvec, b, precond, maxiter, tol, check_every)[0]


def _reduce_cache(pl: BALayout, lin, dist=None):
    """Lambda-independent reductions of a linearization, kept beside it in
    the LM loop (rejected lambda tries reuse them):
      Hpp_raw [9, P]  undamped landmark blocks, sum Jp^T Jp
      gc      [9, C]  camera gradient, sum Jc^T r
      gp      [3, P]  landmark gradient, sum Jp^T r
      Hcc     [81, C] camera diagonal blocks, sum Jc^T Jc
    With `dist` (a rank's share of a distributed problem,
    parallel/dist_ba.py:RankSums) the landmark rows seen from other ranks
    too are summed over the ranks, [Hpp_raw; gp] in one all-reduce; a
    rejected try reuses them with the rest."""
    r, Jc, Jp = lin
    M = r.shape[1]
    Hpp_raw = _pt_sum(pl, (Jp[:, :, None] * Jp[:, None]).sum(0).reshape(9, M))
    gc = _cam_sum(pl, (Jc * r[:, None]).sum(0))
    gp = _pt_sum(pl, (Jp * r[:, None]).sum(0))
    Hcc = _cam_sum(pl, (Jc[:, :, None] * Jc[:, None]).sum(0).reshape(81, M))
    if dist is not None:
        Hpp_raw, gp = dist.boundary(torch.cat([Hpp_raw, gp])).split([9, 3])
    return Hpp_raw, gc, gp, Hcc


def _solve_from_lin(pl: BALayout, lin, red, lam, cg_maxiter=100,
                    cg_tol=1e-6, check_every=None, probe=None, dist=None):
    """The lambda-dependent part of the step, from a (possibly cached)
    linearization: the reference's tryLambda reuses one linearization
    across rejected lambda tries (LevenbergMarquardtOptimizer.cpp:121).
    Returns (delta_cam [C, 9], delta_point [P, 3]) in the original camera
    and landmark order.

    The landmark back-substitution's E^T F xc term is accumulated inside
    the CG loop (tacc += alpha * E^T F p, exact by linearity), so no extra
    matvec follows CG. `check_every` is _pcg's: None (ba_pack's LM) runs
    `cg_maxiter` masked iterations and reads nothing back; the camera-major
    engine passes 8. `probe(label, **info)`, when given, is called after
    the right-hand side and preconditioner ("precond") and after CG ("pcg",
    iterations=0-d tensor): the hook of a timing split.

    `dist` (parallel/dist_ba.py:RankSums, with `red` from _reduce_cache
    with it) solves a rank's share of a distributed problem: `pl` holds the
    rank's rows, its cameras and the landmarks they see. Each Schur matvec
    sums the boundary landmarks' E^T a over the ranks in one all-reduce and
    _pcg sums its dot products; the returned steps are this rank's
    cameras' and landmarks'."""
    r, Jc, Jp = lin
    Hpp_raw, gc, gp, Hcc = red
    M = r.shape[1]
    lam = torch.as_tensor(lam, dtype=r.dtype, device=r.device)
    lam_p = lam + 1e-10                     # landmark damping, 0-d tensor

    def cam_apply(x):                       # [9, C] -> [2, M]
        return (Jc * x[:, pl.cam_of]).sum(1)

    def cam_reduce(u):                      # [2, M] -> [9, C]
        return _cam_sum(pl, (Jc * u[:, None]).sum(0))

    def pt_reduce(a):                       # [2, M] -> [3, P]
        return _pt_sum(pl, (Jp * a[:, None]).sum(0))

    def pt_apply(u):                        # [3, P] -> [2, M]
        return (Jp * u[:, pl.pt_of]).sum(1)

    def pt_solve(t):                        # (Hpp + lam_p I)^{-1} t, [3, P]
        return landmark_block_solve(Hpp_raw, t, lam_p)

    b_rhs = -gc + cam_reduce(pt_apply(pt_solve(gp)))

    def schur_matvec_t(x):
        """Returns (S x + lam x, E^T F x); the second output feeds the
        fused back-substitution accumulator."""
        a = cam_apply(x)
        t = pt_reduce(a)
        if dist is not None:
            t = dist.boundary(t)
        y = cam_reduce(a - pt_apply(pt_solve(t)))
        return y + lam * x, t

    # block-Jacobi preconditioner of S per camera: Hcc - Gc with
    # Gc = sum over rows of W HppInv W^T, W = Jc^T Jp [9, 3] per row
    HppInv = bk.sym33_inv_T(bk.add_scaled_identity_33_T(Hpp_raw, lam_p))
    W = (Jc[:, :, None] * Jp[:, None]).sum(0)              # [9, 3, M]
    Hi = HppInv[:, pl.pt_of].reshape(3, 3, M)
    T1 = (W[:, 0, None] * Hi[0] + W[:, 1, None] * Hi[1]
          + W[:, 2, None] * Hi[2])                        # [9, 3, M] W Hi
    Gc = (T1[:, None, 0] * W[None, :, 0] + T1[:, None, 1] * W[None, :, 1]
          + T1[:, None, 2] * W[None, :, 2])               # [9, 9, M]
    blocks = (Hcc - _cam_sum(pl, Gc.reshape(81, M))).T.reshape(pl.C, 9, 9)
    Ls = bk.safe_chol_blocks(blocks, lam)

    def precond(x):                         # [9, C] -> [9, C]
        return torch.cholesky_solve(x.T[..., None], Ls)[..., 0].T

    if probe is not None:
        probe("precond")
    x, tacc, iters = _pcg(schur_matvec_t, b_rhs, precond, cg_maxiter,
                          cg_tol, check_every, torch.zeros_like(gp), dist)
    xp = pt_solve(-gp - tacc)
    if probe is not None:
        probe("pcg", iterations=iters)
    return x.T.contiguous(), xp.T.contiguous()


def solve_ba_step_cm(state: BAState, obs: BAObservations, layout: BALayout,
                     lam, cg_maxiter=100, cg_tol=1e-6):
    """One damped Gauss-Newton step: implicit-Schur PCG on the cameras
    (stopping at cg_tol, checked every 8 iterations) and landmark
    back-substitution. Returns (delta_cam [C, 9], delta_point [P, 3])."""
    lin = linearize_ba_cm(state, obs, layout)
    return _solve_from_lin(layout, lin, _reduce_cache(layout, lin), lam,
                           cg_maxiter, cg_tol, check_every=8)


# The JAX package's row-major step solves over its dense dual layout; here
# both names are the one solve over the camera-major rows.
solve_ba_step = solve_ba_step_cm


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def ba_try_step(state: BAState, obs: BAObservations, layout: BALayout, lam,
                cg_maxiter=100):
    """Solve at lam, retract, evaluate: (new_state, error as a 0-d
    tensor)."""
    xc, xp = solve_ba_step_cm(state, obs, layout, lam, cg_maxiter=cg_maxiter)
    new_state = retract_ba(state, xc, xp)
    return new_state, ba_error_cm(new_state, obs, layout)


def optimize_ba(state: BAState, obs: BAObservations, layout=None,
                max_iterations=50, lambda_initial=1e-4, lambda_factor=10.0,
                lambda_upper=1e8, rel_tol=1e-6, abs_tol=1e-6, cg_maxiter=100,
                verbose=False, probe=None):
    """LM outer loop on the BA problem (the JAX engine's schedule: up to 12
    tries an iteration, lambda times `lambda_factor` on a reject and past
    `lambda_upper` a stop, divided by it on an accept with a floor of
    1e-12; convergence on the absolute or relative decrease). Returns
    (state, error, iterations).

    The tries of one iteration share its linearization, which is what the
    JAX engine recomputes for each (the state does not move between them).
    One host read a try, of the error; PCG reads its convergence flag every
    8 iterations. `probe` is passed to _solve_from_lin, and also called
    after each linearization ("linearize") and each trial error ("error",
    error=0-d tensor)."""
    if layout is None:
        layout = make_layout(obs, state.cam_poses.shape[0],
                             state.points.shape[0])
    err = float(ba_error(state, obs))
    lam = lambda_initial
    for it in range(max_iterations):
        lin = linearize_ba_cm(state, obs, layout)
        red = _reduce_cache(layout, lin)
        if probe is not None:
            probe("linearize")
        accepted = False
        for _ in range(12):
            xc, xp = _solve_from_lin(layout, lin, red, lam, cg_maxiter,
                                     check_every=8, probe=probe)
            new_state = retract_ba(state, xc, xp)
            err_t = ba_error_cm(new_state, obs, layout)
            if probe is not None:
                probe("error", error=err_t)
            new_err = float(err_t)
            if np.isfinite(new_err) and new_err < err:
                accepted = True
                break
            lam *= lambda_factor
            if lam > lambda_upper:
                return state, err, it
        if not accepted:
            return state, err, it
        if verbose:
            print(f"BA iter {it}: {err:.6g} -> {new_err:.6g} "
                  f"(lambda {lam:.2g})")
        abs_dec = err - new_err
        rel_dec = abs_dec / err if err > 0 else 1.0
        state, err = new_state, new_err
        lam = max(lam / lambda_factor, 1e-12)
        if abs_dec <= abs_tol or rel_dec <= rel_tol:
            return state, err, it + 1
    return state, err, max_iterations
