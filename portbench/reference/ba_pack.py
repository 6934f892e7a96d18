"""Plain reference of the BA path: Levenberg-Marquardt on the reprojection
error of Cal3Bundler cameras, as sfm.ba_pack.ba_lm_run_pk defines it.

One LM try: linearize at the current state (relinearize only after an
accepted try), solve the damped normal equations by the camera Schur
complement with a block-Jacobi preconditioned CG of a fixed number of
iterations (an iteration changes nothing once |r|^2 <= tol^2 |b|^2),
back-substitute the points, retract, and accept if the error fell: lambda
halves (floor lam_lo) on an accept and quadruples (cap lam_hi) on a reject.
Camera damping is lambda I on the Schur complement, point damping
(lambda + 1e-10) I on each 3x3 block; the preconditioner is the Cholesky
factor of each camera's diagonal Schur block plus (lambda + 1e-8) I, or its
diagonal's square root where that block is not positive definite.

Everything is worked out here from the raw observations in their own order:
residuals and Jacobians by forward-mode differentiation of the projection,
sums over observations by index_add_, 3x3 and 9x9 blocks by
torch.linalg. `rnd`, when given, rounds every operand of every product
(lie.einsum): the lower-precision control.
"""

import torch

from portbench.reference import lie

CAM_DIM = 9


def _project(R, t, cal, p, rnd=None):
    """Cal3Bundler projection of world points p through camera-to-world
    (R, t), and the depth. Scalars keep a trailing axis (see lie._coeffs)."""
    pc = lie.einsum("...ji,...j->...i", R, p - t, rnd=rnd)
    z = pc[..., 2:3]
    zs = torch.where(z.abs() < 1e-8, torch.where(z < 0, -1e-8, 1e-8), z)
    pn = pc[..., :2] / zs
    r2 = (pn * pn).sum(-1, keepdim=True)
    g = cal[..., 0:1] * (1 + cal[..., 1:2] * r2 + cal[..., 2:3] * r2 * r2)
    return g * pn, z[..., 0]


def residuals(state, obs, rnd=None):
    """r [M, 2] masked to rows in front of the camera (depth > 1e-6)."""
    poses, cals, points = state
    cam, pt, uv = obs
    pose = poses[cam]
    uvh, z = _project(pose[:, :, :3], pose[:, :, 3], cals[cam], points[pt],
                      rnd)
    return (uvh - uv) * (z > 1e-6).to(uv.dtype)[:, None]


def error(state, obs, rnd=None):
    r = residuals(state, obs, rnd)
    return 0.5 * (r * r).sum()


def _row_residual(d, R, t, cal, p, uv):
    """One row's residual at the camera tangent d[:9] = (omega, v, dcal) and
    point step d[9:], to first order in d (the Jacobian at d = 0 is the
    retraction's)."""
    Rn = R @ (torch.eye(3, dtype=R.dtype, device=R.device) + lie.hat(d[:3]))
    tn = t + R @ d[3:6]
    return _project(Rn, tn, cal + d[6:9], p + d[9:12])[0] - uv


def linearize(state, obs, rnd=None, chunk=1 << 18):
    """r [M, 2], Jc [M, 2, 9], Jp [M, 2, 3], rows behind the camera zero;
    `rnd` acts on the residuals (forward-mode differentiation takes the
    products as they are)."""
    poses, cals, points = state
    cam, pt, uv = obs
    jac = torch.func.vmap(torch.func.jacfwd(_row_residual))
    J = []
    for s in range(0, cam.shape[0], chunk):
        c, q = cam[s:s + chunk], pt[s:s + chunk]
        d0 = poses.new_zeros(c.shape[0], 12)
        J.append(jac(d0, poses[c, :, :3], poses[c, :, 3], cals[c], points[q],
                     uv[s:s + chunk]))
    J = torch.cat(J)
    pose = poses[cam]
    _, z = _project(pose[:, :, :3], pose[:, :, 3], cals[cam], points[pt])
    w = (z > 1e-6).to(J.dtype)
    J = J * w[:, None, None]
    return residuals(state, obs, rnd), J[:, :, :9], J[:, :, 9:]


def _sum(idx, x, n):
    return x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx, x)


def step(lin, obs, C, P, lam, cg_maxiter, cg_tol=1e-6, rnd=None):
    """(dcam [C, 9], dpoint [P, 3]) of one damped Schur-PCG step."""
    r, Jc, Jp = lin
    cam, pt, _ = obs
    mm = lambda eq, *a: lie.einsum(eq, *a, rnd=rnd)   # noqa: E731
    eye3 = torch.eye(3, dtype=r.dtype, device=r.device)
    eye9 = torch.eye(9, dtype=r.dtype, device=r.device)
    Hpp = _sum(pt, mm("mki,mkj->mij", Jp, Jp), P)
    Hcc = _sum(cam, mm("mki,mkj->mij", Jc, Jc), C)
    gc = _sum(cam, mm("mki,mk->mi", Jc, r), C)
    gp = _sum(pt, mm("mki,mk->mi", Jp, r), P)
    W = mm("mki,mkj->mij", Jc, Jp)                        # [M, 9, 3]
    Hinv = torch.linalg.inv(Hpp + (lam + 1e-10) * eye3)   # [P, 3, 3]
    HinvW = mm("mij,mkj->mik", Hinv[pt], W)               # [M, 3, 9]

    def cam_to_pt(x):          # sum over a point's rows of W^T x_cam
        return _sum(pt, mm("mij,mi->mj", W, x[cam]), P)

    def pt_to_cam(u):          # sum over a camera's rows of W Hinv u_pt
        return _sum(cam, mm("mij,mj->mi", W, mm("mij,mj->mi", Hinv[pt],
                                                   u[pt])), C)

    def schur(x):
        return mm("cij,cj->ci", Hcc, x) + lam * x - pt_to_cam(cam_to_pt(x))

    blocks = Hcc - _sum(cam, mm("mij,mjk->mik", W, HinvW), C)
    L, info = torch.linalg.cholesky_ex(blocks + (lam + 1e-8) * eye9)
    bad = (info != 0) | ~torch.isfinite(L).flatten(1).all(1)
    diag = torch.clamp(torch.diagonal(blocks, dim1=-2, dim2=-1), min=0) \
        + lam + 1e-8
    L = torch.where(bad[:, None, None], torch.sqrt(diag)[:, :, None] * eye9, L)

    def precond(x):
        return torch.cholesky_solve(x[:, :, None], L)[:, :, 0]

    b = -gc + pt_to_cam(gp)
    x = torch.zeros_like(b)
    res = b
    z = precond(b)
    p = z
    rz = (b * z).sum()
    thr = cg_tol ** 2 * (b * b).sum()
    for _ in range(cg_maxiter):
        active = (res * res).sum() > thr
        Ap = schur(p)
        pAp = (p * Ap).sum()
        alpha = torch.where(pAp > 0, rz / torch.where(pAp != 0, pAp, 1.0),
                            0.0)
        res_n = res - alpha * Ap
        z = precond(res_n)
        rz_n = (res_n * z).sum()
        beta = rz_n / torch.where(rz != 0, rz, 1.0)
        x = torch.where(active, x + alpha * p, x)
        p = torch.where(active, z + beta * p, p)
        res = torch.where(active, res_n, res)
        rz = torch.where(active, rz_n, rz)
    dp = mm("pij,pj->pi", Hinv, -gp - cam_to_pt(x))
    return x, dp


def retract(state, dc, dp):
    poses, cals, points = state
    return (lie.se3_retract(poses, dc[:, :6]), cals + dc[:, 6:9],
            points + dp)


def lm_run(state, obs, lam, n_iters, cg_maxiter, lam_lo=1e-6, lam_hi=1e3,
           rnd=None):
    """(state, lam, err) after `n_iters` tries; lam and err as floats."""
    C, P = state[0].shape[0], state[2].shape[0]
    err = float(error(state, obs, rnd))
    need = True
    for _ in range(n_iters):
        if need:
            lin = linearize(state, obs, rnd)
        dc, dp = step(lin, obs, C, P, lam, cg_maxiter, rnd=rnd)
        trial = retract(state, dc, dp)
        e = float(error(trial, obs, rnd))
        need = e == e and e < err
        if need:
            state, err, lam = trial, e, max(lam * 0.5, lam_lo)
        else:
            lam = min(lam * 4.0, lam_hi)
    return state, lam, err
