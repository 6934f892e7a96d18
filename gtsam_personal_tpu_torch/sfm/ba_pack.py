"""Bundle-adjustment Levenberg-Marquardt engine on the GPU layout.

JAX counterpart: gtsam_personal_tpu/sfm/ba_pack.py:433-771 (linearize_ba_pk,
ba_error_pk, _reduce_cache, _solve_from_lin, solve_ba_step_pk, retract_ba,
ba_lm_iter_pk, ba_lm_run_pk, optimize_ba_pk) and
gtsam_personal_tpu/sfm/ba_bucket.py:278-327 (_analytic_rJ). Public names and
signatures are the JAX module's; `pl` is a `sfm/ba_layout.py:BALayout`
instead of the TPU's PackLayout.

Per-observation quantities are feature-major [k, M] tensors over the rows
of the layout (observations sorted camera-major). Camera and landmark
values reach a row by a gather, `x[:, cam_of]` or `u[:, pt_of]`; the JAX
engine's tile permutations (_cam_to_point, _point_to_cam, _relayout_pm) are
not needed. Per-camera and per-landmark sums are `index_add_` over
`cam_of` / `pt_of`: one kernel per reduction and no permutation of the rows
into landmark-major order. On CUDA, `index_add_` accumulates with atomics,
so the order of a sum, and with it the last bits of a float32 result, can
change from run to run. A prefix-sum difference would be deterministic but
cancels catastrophically in float32 over 529k rows, so it is not used.

The math is that of the JAX engine (reference algebra:
slam/RegularImplicitSchurFactor.h, y += F'(I - E P E') F x, lifted to the
whole problem); tests/test_torch_ba.py holds the two against each other.
"""

import torch

from gtsam_personal_tpu_torch import config  # noqa: F401  (TF32 off)
from gtsam_personal_tpu_torch.geometry import cameras as cam_geo
from gtsam_personal_tpu_torch.linear.noise import robust_loss, robust_weight
from gtsam_personal_tpu_torch.ops.block_solve import landmark_block_solve
from gtsam_personal_tpu_torch.sfm import ba_kernels as bk
from gtsam_personal_tpu_torch.sfm.ba import (BAObservations, BAState,
                                             _residual_one, retract_ba)
from gtsam_personal_tpu_torch.sfm.ba_layout import BALayout, build_layout

__all__ = ["make_pack_layout", "linearize_ba_pk", "ba_error_pk",
           "solve_ba_step_pk", "retract_ba", "ba_lm_iter_pk", "ba_lm_run_pk",
           "optimize_ba_pk"]


def make_pack_layout(obs: BAObservations, C: int, P: int) -> BALayout:
    """Index plan of `obs` on its own device and dtype (one host copy of the
    observations, at set-up)."""
    return build_layout(obs.cam.cpu().numpy(), obs.point.cpu().numpy(),
                        obs.uv.cpu().numpy(), C, P, device=obs.uv.device,
                        dtype=obs.uv.dtype)


def _cam_sum(pl: BALayout, x):
    """Per-camera sums of rows: [k, M] -> [k, C]."""
    return x.new_zeros(x.shape[0], pl.C).index_add_(1, pl.cam_of, x)


def _pt_sum(pl: BALayout, x):
    """Per-landmark sums of rows: [k, M] -> [k, P]."""
    return x.new_zeros(x.shape[0], pl.P).index_add_(1, pl.pt_of, x)


# ---------------------------------------------------------------------------
# linearize / error
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


def _row_inputs(state: BAState, pl: BALayout):
    """Per-row camera pose [3, 4, M], calibration [3, M] and point [3, M]."""
    C = pl.C
    posesT = state.cam_poses.reshape(C, 12).T[:, pl.cam_of].reshape(3, 4, -1)
    return posesT, state.cam_cals.T[:, pl.cam_of], state.points.T[:, pl.pt_of]


def linearize_ba_pk(state: BAState, obs: BAObservations, pl: BALayout,
                    robust: str = "none", robust_k=1.0):
    """Analytic linearization of every row. Returns r [2, M], Jc [2, 9, M],
    Jp [2, 3, M], zero on rows behind the camera (depth <= 1e-6).

    robust != 'none' applies the IRLS sqrt-weight of the named m-estimator
    to each row's residual and Jacobians (the reference's
    Robust::WhitenSystem, fixed-weight approximation, no Triggs
    correction). `obs` is carried for the JAX signature; the layout holds
    the measurements."""
    posesT, calsT, pts = _row_inputs(state, pl)
    r, Jc, Jp, depth = _analytic_rJ(posesT, calsT, pts, pl.uv_cm)
    w = (depth > 1e-6).to(r.dtype)
    if robust != "none":
        e = torch.sqrt(r[0] * r[0] + r[1] * r[1] + 1e-30)
        w = w * torch.sqrt(robust_weight(robust, e, robust_k))
    return r * w, Jc * w, Jp * w


def ba_error_pk(state: BAState, obs: BAObservations, pl: BALayout,
                robust: str = "none", robust_k=1.0):
    """Total error as a 0-d tensor: 0.5 sum |r|^2 over rows in front of the
    camera, or sum rho(|r|) for a robust kind."""
    pose = state.cam_poses[pl.cam_of]                     # [M, 3, 4]
    point = state.points[pl.pt_of]                        # [M, 3]
    r = _residual_one(pose, state.cam_cals[pl.cam_of], point, pl.uv_cm.T)
    w = (cam_geo.depth_of(pose, point) > 1e-6).to(r.dtype)
    r = r * w[:, None]
    if robust != "none":
        e = torch.sqrt(r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1] + 1e-30)
        return (w * robust_loss(robust, e, robust_k)).sum()
    return 0.5 * (r * r).sum()


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------

def solve_ba_step_pk(state: BAState, obs: BAObservations, pl: BALayout,
                     lam, cg_maxiter=100, cg_tol=1e-6,
                     robust: str = "none", robust_k=1.0):
    """Implicit-Schur PCG step. Returns (delta_cam [C, 9],
    delta_point [P, 3]) in the original camera and landmark order."""
    lin = linearize_ba_pk(state, obs, pl, robust, robust_k)
    return _solve_from_lin(pl, lin, _reduce_cache(pl, lin), lam, cg_maxiter,
                           cg_tol)


def _reduce_cache(pl: BALayout, lin):
    """Lambda-independent reductions of a linearization, kept beside it in
    the LM loop (rejected lambda tries reuse them):
      Hpp_raw [9, P]  undamped landmark blocks, sum Jp^T Jp
      gc      [9, C]  camera gradient, sum Jc^T r
      gp      [3, P]  landmark gradient, sum Jp^T r
      Hcc     [81, C] camera diagonal blocks, sum Jc^T Jc"""
    r, Jc, Jp = lin
    M = r.shape[1]
    Hpp_raw = _pt_sum(pl, (Jp[:, :, None] * Jp[:, None]).sum(0).reshape(9, M))
    gc = _cam_sum(pl, (Jc * r[:, None]).sum(0))
    gp = _pt_sum(pl, (Jp * r[:, None]).sum(0))
    Hcc = _cam_sum(pl, (Jc[:, :, None] * Jc[:, None]).sum(0).reshape(81, M))
    return Hpp_raw, gc, gp, Hcc


def _solve_from_lin(pl: BALayout, lin, red, lam, cg_maxiter=100,
                    cg_tol=1e-6):
    """The lambda-dependent part of the step, from a (possibly cached)
    linearization: the reference's tryLambda reuses one linearization
    across rejected lambda tries (LevenbergMarquardtOptimizer.cpp:121).

    The landmark back-substitution's E^T F xc term is accumulated inside
    the CG loop (tacc += alpha * E^T F p, exact by linearity), so no extra
    matvec follows CG.

    PCG runs exactly `cg_maxiter` iterations with masked updates: an
    iteration changes x, rr, p, rz and tacc only while rr.rr > cg_tol^2
    b.b, the same result as the JAX engine's while_loop with its tolerance
    exit, and no value is read back to the host inside the loop."""
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

    x = torch.zeros_like(b_rhs)
    rr = b_rhs
    z = precond(b_rhs)
    p = z
    rz = (b_rhs * z).sum()
    thr = (cg_tol ** 2) * (b_rhs * b_rhs).sum()
    tacc = torch.zeros_like(gp)
    for _ in range(cg_maxiter):
        active = (rr * rr).sum() > thr      # 0-d device tensor, never read
        Ap, tp = schur_matvec_t(p)
        pAp = (p * Ap).sum()
        alpha = torch.where(pAp > 0, rz / torch.where(pAp != 0, pAp, 1.0),
                            0.0)
        rr_n = rr - alpha * Ap
        z = precond(rr_n)
        rz_n = (rr_n * z).sum()
        beta = rz_n / torch.where(rz != 0, rz, 1.0)
        x = torch.where(active, x + alpha * p, x)
        tacc = torch.where(active, tacc + alpha * tp, tacc)
        p = torch.where(active, z + beta * p, p)
        rr = torch.where(active, rr_n, rr)
        rz = torch.where(active, rz_n, rz)

    xp = pt_solve(-gp - tacc)
    return x.T.contiguous(), xp.T.contiguous()


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def _lm_try(state, obs, pl, lam, err, lin, red, cg_maxiter, lam_lo, lam_hi,
            robust, robust_k):
    """One accept/reject try from a linearization. ok, lam and err stay 0-d
    device tensors; the state update is a select."""
    xc, xp = _solve_from_lin(pl, lin, red, lam, cg_maxiter)
    trial = retract_ba(state, xc, xp)
    err_t = ba_error_pk(trial, obs, pl, robust, robust_k)
    ok = torch.isfinite(err_t) & (err_t < err)
    new_state = BAState(*(torch.where(ok, a, b) for a, b in zip(trial, state)))
    new_lam = torch.where(ok, torch.clamp(lam * 0.5, min=lam_lo),
                          torch.clamp(lam * 4.0, max=lam_hi))
    return new_state, new_lam, torch.where(ok, err_t, err), ok


def _as_scalar(v, state: BAState):
    return torch.as_tensor(v, dtype=state.points.dtype,
                           device=state.points.device)


def ba_lm_iter_pk(state: BAState, obs: BAObservations, pl: BALayout,
                  lam, err, cg_maxiter=100, lam_lo=1e-6, lam_hi=1e3,
                  robust: str = "none", robust_k=1.0):
    """One LM iteration from a fresh linearization (tryLambda semantics).
    Returns (state, lam, err)."""
    lam, err = _as_scalar(lam, state), _as_scalar(err, state)
    lin = linearize_ba_pk(state, obs, pl, robust, robust_k)
    st, lam, err, _ = _lm_try(state, obs, pl, lam, err, lin,
                              _reduce_cache(pl, lin), cg_maxiter, lam_lo,
                              lam_hi, robust, robust_k)
    return st, lam, err


def ba_lm_run_pk(state: BAState, obs: BAObservations, pl: BALayout,
                 lam, err, n_iters, cg_maxiter=100,
                 lam_lo=1e-6, lam_hi=1e3, robust: str = "none",
                 robust_k=1.0):
    """`n_iters` LM iterations; returns (state, lam, err) with lam and err
    as 0-d device tensors.

    The loop relinearizes only after an accepted try. On a rejected try the
    state is selected unchanged, bit for bit, so the cached linearization
    and reductions are bit-identical to recomputing them (the JAX engine's
    lax.cond at sfm/ba_pack.py:681). Deciding that costs one host read per
    iteration, of the accept flag, and it is the only one: lambda, the
    error and the state never leave the device."""
    lam, err = _as_scalar(lam, state), _as_scalar(err, state)
    need_relin = True
    for i in range(n_iters):
        if need_relin:
            lin = linearize_ba_pk(state, obs, pl, robust, robust_k)
            red = _reduce_cache(pl, lin)
        state, lam, err, ok = _lm_try(state, obs, pl, lam, err, lin, red,
                                      cg_maxiter, lam_lo, lam_hi, robust,
                                      robust_k)
        if i + 1 < n_iters:
            need_relin = bool(ok)           # the one host read
    return state, lam, err


def optimize_ba_pk(state: BAState, obs: BAObservations, pl=None,
                   max_iterations=50, chunk=5, cg_maxiter=10,
                   lambda_initial=1e-3, rel_tol=1e-6,
                   robust: str = "none", robust_k=1.0, verbose=False):
    """LM outer loop: runs `chunk` iterations per ba_lm_run_pk call and
    checks convergence on the host between chunks.

    Returns (state, error, iterations_run). Every inner iteration is an
    accept/reject tryLambda step, so rejected tries count as iterations,
    as in LevenbergMarquardtOptimizer."""
    if pl is None:
        pl = make_pack_layout(obs, state.cam_poses.shape[0],
                              state.points.shape[0])
    err = ba_error_pk(state, obs, pl, robust, robust_k)
    lam = _as_scalar(lambda_initial, state)
    err_h = float(err)
    it = 0
    while it < max_iterations:
        n = min(chunk, max_iterations - it)
        state, lam, err = ba_lm_run_pk(state, obs, pl, lam, err, n_iters=n,
                                       cg_maxiter=cg_maxiter, robust=robust,
                                       robust_k=robust_k)
        it += n
        new_err = float(err)
        if verbose:
            print(f"BA iters {it}: error {new_err:.6g} (lambda "
                  f"{float(lam):.2g})")
        if err_h - new_err < rel_tol * max(err_h, 1e-30):
            err_h = new_err
            break
        err_h = new_err
    return state, err_h, it
