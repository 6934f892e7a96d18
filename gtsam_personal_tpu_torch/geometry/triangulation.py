"""Point triangulation from several views: DLT, LOST, nonlinear refinement,
refinement differentiated by the implicit function theorem, and masked
"safe" triangulation.

JAX counterpart: gtsam_personal_tpu/geometry/triangulation.py (all of it;
reference: gtsam/geometry/triangulation.h, triangulateDLT :65-96, LOST
:102-111, the nonlinear refinement :179-211, triangulateSafe). The reference
throws on a bad camera set; here the status is a mask.

The functions take the stacked camera-to-world poses of one track
[N, 3, 4] and its unit-plane measurements [N, 2], as the JAX package's do,
and run under `torch.func.vmap` and `jacfwd`.
"""

from typing import NamedTuple

import torch

from gtsam_personal_tpu_torch.geometry import se3


class TriangulationResult(NamedTuple):
    """Status flags with the reference's TriangulationResult meaning."""
    point: torch.Tensor       # [3]
    valid: torch.Tensor       # well conditioned and in front of the cameras
    degenerate: torch.Tensor  # rank-deficient geometry
    behind: torch.Tensor      # cheirality failure


def _projection_rows(poses, uv):
    """The two DLT rows [N, 2, 4] of each view: u P_2 - P_0, v P_2 - P_1
    with P = [R^T | -R^T t] the world-to-camera projection."""
    Rt = poses[..., :3].transpose(-1, -2)
    P = torch.cat([Rt, -(Rt @ poses[..., 3:4])], dim=-1)         # [N, 3, 4]
    u, v = uv[..., 0:1], uv[..., 1:2]
    return torch.stack([u * P[..., 2, :] - P[..., 0, :],
                        v * P[..., 2, :] - P[..., 1, :]], dim=-2)


def _null_point(A):
    """The dehomogenized right singular vector of the smallest singular
    value of A [M, 4], and the singular values."""
    _, s, vt = torch.linalg.svd(A, full_matrices=False)
    X = vt[..., -1, :]
    w = X[..., 3:4]
    tiny = torch.full_like(w, 1e-12)
    w_safe = torch.where(w.abs() < 1e-12, torch.where(w < 0, -tiny, tiny), w)
    return X[..., :3] / w_safe, s


def triangulate_dlt(poses, measurements_unit, rank_tol=1e-9):
    """Linear DLT: the homogeneous least-squares point of
    sum_i ||[u_i]_x P_i X||^2 by SVD. Returns (point [3], degenerate)."""
    A = _projection_rows(poses, measurements_unit).reshape(-1, 4)
    point, s = _null_point(A)
    degenerate = s[..., -2] < rank_tol * torch.clamp(s[..., 0], min=1e-30)
    return point, degenerate


def triangulate_lost(poses, measurements_unit, sigma=1e-3):
    """LOST, linear optimal sine triangulation (triangulation.h:102-111):
    each view's DLT rows weighted by the sine of the angle between its ray
    and the baseline to the next camera over the measurement sigma."""
    t = poses[..., 3]
    others = torch.roll(t, -1, dims=0)
    ones = torch.ones_like(measurements_unit[..., :1])
    ray = (poses[..., :3]
           @ torch.cat([measurements_unit, ones], dim=-1)[..., None])[..., 0]
    ray = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    b = others - t
    q = (torch.linalg.norm(torch.linalg.cross(b, ray, dim=-1), dim=-1)
         / (sigma * torch.clamp(torch.linalg.norm(b, dim=-1), min=1e-12)))
    A = (q[:, None, None] * _projection_rows(poses, measurements_unit))
    _, s, vt = torch.linalg.svd(A.reshape(-1, 4), full_matrices=False)
    X = vt[-1]
    w = X[3:4]
    w_safe = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return X[:3] / w_safe, s[-2] < 1e-9 * torch.clamp(s[0], min=1e-30)


def _reprojection(poses, measurements_unit, point):
    """Unit-plane reprojection errors [N, 2] of `point` in every view."""
    pc = se3.transform_to(poses, point)
    z = pc[..., 2:3]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    return pc[..., :2] / z_safe - measurements_unit


def solve3(H, g):
    """H^{-1} g for 3 x 3 systems [..., 3, 3], [..., 3], by the adjugate:
    the columns of H^{-1} are the cross products of H's rows over det H.

    The Gauss-Newton steps that `linearize` differentiates take this and not
    `torch.linalg.solve`: under `vmap` of `jacfwd` (linearize's form) the
    forward-mode derivative of `torch.linalg.solve` and of `lu_solve` comes
    out wrong for every batch element but the first (torch 2.13, on the CPU),
    while these elementwise products differentiate correctly."""
    r0, r1, r2 = H[..., 0, :], H[..., 1, :], H[..., 2, :]
    c0 = torch.linalg.cross(r1, r2, dim=-1)
    c1 = torch.linalg.cross(r2, r0, dim=-1)
    c2 = torch.linalg.cross(r0, r1, dim=-1)
    det = (r0 * c0).sum(-1, keepdim=True)
    return (g[..., 0:1] * c0 + g[..., 1:2] * c1 + g[..., 2:3] * c2) / det


def refine_nonlinear(poses, measurements_unit, point0, iters=5):
    """Gauss-Newton refinement of the point (triangulation.h:179-211): the
    3 x 3 normal equations in closed form, a fixed number of iterations."""
    point = point0
    jac = torch.func.jacfwd(_reprojection, argnums=2)
    eye = torch.eye(3, dtype=point0.dtype, device=point0.device)
    for _ in range(iters):
        r = _reprojection(poses, measurements_unit, point)      # [N, 2]
        J = jac(poses, measurements_unit, point)                 # [N, 2, 3]
        H = torch.einsum("nij,nik->jk", J, J) + 1e-12 * eye
        g = torch.einsum("nij,ni->j", J, r)
        point = point - solve3(H, g)
    return point


def _normal_gradient(point, poses, measurements_unit):
    """g(p) = J(p)^T r(p), zero at the refined point."""
    r = _reprojection(poses, measurements_unit, point).reshape(-1)
    J = torch.func.jacfwd(
        lambda p: _reprojection(poses, measurements_unit, p).reshape(-1))(
            point)
    return J.transpose(0, 1) @ r


class _ImplicitRefine(torch.autograd.Function):
    """refine_nonlinear whose derivative is that of the argmin, by the
    implicit function theorem at the returned point: the JAX package's
    `lax.custom_root` (triangulation.py:116-145). The primal runs the GN
    iterations on the inputs as given, with no tangents; the tangent of the
    point is -A^{-1} (dg/dposes dposes + dg/duv duv), A = dg/dpoint + 1e-10 I
    (the degenerate-track guard of the JAX package), and takes nothing from
    the initial guess."""
    generate_vmap_rule = True

    @staticmethod
    def forward(poses, measurements_unit, point0, iters):
        return refine_nonlinear(poses, measurements_unit, point0, iters)

    @staticmethod
    def setup_context(ctx, inputs, output):
        poses, measurements_unit, _, _ = inputs
        ctx.save_for_forward(poses, measurements_unit, output)

    @staticmethod
    def jvp(ctx, dposes, duv, dpoint0, diters):
        poses, uv, point = ctx.saved_tensors
        A = torch.func.jacfwd(_normal_gradient)(point, poses, uv)
        A = A + 1e-10 * torch.eye(3, dtype=point.dtype, device=point.device)
        zero_p = torch.zeros_like(poses) if dposes is None else dposes
        zero_u = torch.zeros_like(uv) if duv is None else duv
        _, b = torch.func.jvp(lambda p, u: _normal_gradient(point, p, u),
                              (poses, uv), (zero_p, zero_u))
        return -torch.linalg.solve(A, b)


def refine_nonlinear_implicit(poses, measurements_unit, point0, iters=5):
    """`refine_nonlinear` with the derivative of the argmin (the exact
    Schur-complement Jacobian the reference builds at the triangulated
    point, slam/SmartFactorBase.h:320), not of the truncated iterations."""
    return _ImplicitRefine.apply(poses, measurements_unit, point0, iters)


def triangulate_safe(poses, measurements_unit, rank_tol=1e-9, refine=True,
                     min_depth=1e-3) -> TriangulationResult:
    """triangulateSafe analogue: DLT, optional refinement, and cheirality
    and degeneracy flags in place of exceptions."""
    point, degenerate = triangulate_dlt(poses, measurements_unit, rank_tol)
    if refine:
        point = refine_nonlinear(poses, measurements_unit, point)
    depths = se3.transform_to(poses, point)[..., 2]
    behind = torch.any(depths < min_depth)
    valid = torch.logical_and(torch.logical_not(degenerate),
                              torch.logical_not(behind))
    return TriangulationResult(point, valid, degenerate, behind)


def pixels_to_unit(measurements_px, cal_fxfycxcy):
    """Pixels -> unit plane through a pinhole calibration [fx, fy, cx, cy]
    (no distortion)."""
    fx, fy, cx, cy = cal_fxfycxcy
    return torch.stack([(measurements_px[..., 0] - cx) / fx,
                        (measurements_px[..., 1] - cy) / fy], dim=-1)
