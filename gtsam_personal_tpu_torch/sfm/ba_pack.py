"""Bundle-adjustment Levenberg-Marquardt engine on the GPU layout.

JAX counterpart: gtsam_personal_tpu/sfm/ba_pack.py:433-771 (linearize_ba_pk,
ba_error_pk, _reduce_cache, _solve_from_lin, solve_ba_step_pk, retract_ba,
ba_lm_iter_pk, ba_lm_run_pk, optimize_ba_pk; the linearization,
_reduce_cache and _solve_from_lin live in sfm/ba.py and are re-exported
here). Public names and signatures are the JAX module's; `pl` is a
`sfm/ba_layout.py:BALayout` instead of the TPU's PackLayout.

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

The linearization, the reductions and the Schur-PCG solve are sfm/ba.py's,
shared with the camera-major engine there; this module is the JAX packed
engine's LM schedule over them (a fixed number of masked CG iterations,
lambda halved or quadrupled inside [lam_lo, lam_hi], one host read an
iteration). The math is that of the JAX engine (reference algebra:
slam/RegularImplicitSchurFactor.h, y += F'(I - E P E') F x, lifted to the
whole problem); tests/test_torch_ba.py holds the two against each other.
"""

import torch

from gtsam_personal_tpu_torch import config  # noqa: F401  (TF32 off)
from gtsam_personal_tpu_torch.sfm.ba import (  # noqa: F401  (re-exported)
    BAObservations, BAState, _reduce_cache, _rows_error, _rows_rJ,
    _solve_from_lin, make_layout, retract_ba)
from gtsam_personal_tpu_torch.sfm.ba_layout import BALayout

__all__ = ["make_pack_layout", "linearize_ba_pk", "ba_error_pk",
           "solve_ba_step_pk", "retract_ba", "ba_lm_iter_pk", "ba_lm_run_pk",
           "optimize_ba_pk"]

make_pack_layout = make_layout


def linearize_ba_pk(state: BAState, obs: BAObservations, pl: BALayout,
                    robust: str = "none", robust_k=1.0):
    """Analytic linearization of every row. Returns r [2, M], Jc [2, 9, M],
    Jp [2, 3, M], zero on rows behind the camera (depth <= 1e-6).

    robust != 'none' applies the IRLS sqrt-weight of the named m-estimator
    to each row's residual and Jacobians (the reference's
    Robust::WhitenSystem, fixed-weight approximation, no Triggs
    correction). `obs` is carried for the JAX signature; the layout holds
    the measurements."""
    return _rows_rJ(state, pl.cam_of, pl.pt_of, pl.uv_cm, True, robust,
                    robust_k)


def ba_error_pk(state: BAState, obs: BAObservations, pl: BALayout,
                robust: str = "none", robust_k=1.0):
    """Total error as a 0-d tensor: 0.5 sum |r|^2 over rows in front of the
    camera, or sum rho(|r|) for a robust kind."""
    return _rows_error(state, pl.cam_of, pl.pt_of, pl.uv_cm.T, True, robust,
                       robust_k)


def solve_ba_step_pk(state: BAState, obs: BAObservations, pl: BALayout,
                     lam, cg_maxiter=100, cg_tol=1e-6,
                     robust: str = "none", robust_k=1.0):
    """Implicit-Schur PCG step of exactly `cg_maxiter` masked iterations
    (the JAX engine's while_loop with its tolerance exit gives the same
    result), no value read back to the host. Returns (delta_cam [C, 9],
    delta_point [P, 3]) in the original camera and landmark order."""
    lin = linearize_ba_pk(state, obs, pl, robust, robust_k)
    return _solve_from_lin(pl, lin, _reduce_cache(pl, lin), lam, cg_maxiter,
                           cg_tol)


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
