"""More manifold types: Unit3, Sim(3), the essential matrix, OrientedPlane3,
Line3, the spherical camera and Sim(2).

JAX counterpart: gtsam_personal_tpu/geometry/extra.py (all of it: Unit3
:19-57, Sim3 :68-132, Essential :144-172, OrientedPlane3 :186-213, Line3
:216-252, spherical :255-270, Sim2 :274-366; reference: Unit3.h,
Similarity3.h, EssentialMatrix.h, OrientedPlane3.h, Line3.h,
SphericalCamera.h, Similarity2.h). The functions take any number of leading
batch axes, and one element under `torch.func.vmap`; six manifolds are
registered: unit3, sim3, essential, oriented_plane3, line3, sim2.

The guards follow the JAX package's exactly, since its Jacobians are the
reference: `_clip` and `_max` are `torch.minimum`/`torch.maximum` against a
tensor, whose forward derivative splits a tie half and half as `jnp.clip`
and `jnp.maximum` do (`torch.clamp` passes the whole tangent at the bound);
a norm is sqrt(sum(x^2)), as `jnp.linalg.norm` computes it; scalars keep a
trailing axis of size 1 (see geometry/so3.py on 0-dim tangents). Where a
guard selects a constant, the other branch's tangent is dropped by
`torch.where`, not multiplied by zero, so a NaN there never reaches the
result.

`unit3_retract` keeps a quirk of the JAX package: below its small-angle
guard it takes cos(1), not cos(0), as the coefficient of n (extra.py:39),
so the retraction's derivative at zero is 1/cos(1) times the unit one. The
port keeps it, so that Jacobians agree; ROADMAP queue 3 records it.
"""

import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import se3, so2, so3


def _norm(x):
    """Euclidean norm over the last axis, keeping it: [..., 1]."""
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _max(x, c):
    return torch.maximum(x, torch.full_like(x, c))


def _clip(x, lo, hi):
    """`jnp.clip`: maximum with lo, then minimum with hi."""
    return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                         torch.full_like(x, hi))


def _matvec(A, x):
    return (A @ x[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Unit3: a direction on S^2 stored as [..., 3], 2-dof tangent
# ---------------------------------------------------------------------------

def unit3_basis(n):
    """Two orthonormal tangent vectors at n (reference: Unit3::basis): the
    cross product with the axis least aligned with n, then n x b1."""
    one, zero = torch.ones_like(n[..., 0]), torch.zeros_like(n[..., 0])
    ax = torch.where((n[..., 0].abs() < 0.9)[..., None],
                     torch.stack([one, zero, zero], dim=-1),
                     torch.stack([zero, one, zero], dim=-1))
    b1 = torch.linalg.cross(n, ax, dim=-1)
    b1 = b1 / _max(_norm(b1), 1e-12)
    return b1, torch.linalg.cross(n, b1, dim=-1)


def unit3_retract(n, xi):
    """Exponential map on the sphere along xi in the basis at n."""
    b1, b2 = unit3_basis(n)
    v = xi[..., 0:1] * b1 + xi[..., 1:2] * b2
    theta2 = _dot(v, v)
    small = theta2 < 1e-12
    t = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(t) / t)
    out = torch.cos(t) * n + A * v
    return out / _max(_norm(out), 1e-12)


def unit3_local(n, m):
    """Tangent at n that retracts to m: the angle along the great circle,
    in n's basis; at coincidence the scale theta / |perp| takes its limit
    1."""
    b1, b2 = unit3_basis(n)
    c = _clip(_dot(n, m), -1.0, 1.0)
    theta = torch.arccos(c)
    perp = m - c * n
    s = _norm(perp)
    tiny = s < 1e-12
    s_safe = torch.where(tiny, torch.ones_like(s), s)
    scale = torch.where(tiny, torch.ones_like(s), theta / s_safe)
    v = scale * perp
    return torch.cat([_dot(v, b1), _dot(v, b2)], dim=-1)


def _unit3_identity(*, device, dtype):
    return torch.tensor([0.0, 0.0, 1.0], device=device, dtype=dtype)


UNIT3 = manifolds.register(manifolds.Manifold(
    "unit3", 2, (3,), unit3_retract, unit3_local, _unit3_identity))


# ---------------------------------------------------------------------------
# Sim(3): [..., 3, 5] = [R | t | (s, 0, 0)], tangent (omega, v, lambda)
# ---------------------------------------------------------------------------

def sim3_make(R, t, s):
    """s is [..., 1] (or a tensor that broadcasts to it)."""
    s = s.reshape(t.shape[:-1] + (1,))
    col = torch.cat([s, torch.zeros_like(t[..., :2])], dim=-1)
    return torch.cat([R, t[..., None], col[..., None]], dim=-1)


def sim3_R(g):
    return g[..., :3]


def sim3_t(g):
    return g[..., 3]


def sim3_s(g):
    """The scale as [..., 1]."""
    return g[..., 0, 4:5]


def sim3_identity(*, device, dtype):
    return sim3_make(torch.eye(3, device=device, dtype=dtype),
                     torch.zeros(3, device=device, dtype=dtype),
                     torch.ones(1, device=device, dtype=dtype))


def sim3_compose(a, b):
    return sim3_make(sim3_R(a) @ sim3_R(b),
                     sim3_t(a) + sim3_s(a) * _matvec(sim3_R(a), sim3_t(b)),
                     sim3_s(a) * sim3_s(b))


def sim3_inverse(a):
    Rinv = sim3_R(a).transpose(-1, -2)
    sinv = 1.0 / sim3_s(a)
    return sim3_make(Rinv, -sinv * _matvec(Rinv, sim3_t(a)), sinv)


def sim3_transform(g, p):
    return sim3_s(g) * _matvec(sim3_R(g), p) + sim3_t(g)


def _sim3_a(lam, s):
    """(s - 1) / lambda, its limit 1 + lambda / 2 below |lambda| = 1e-8."""
    small = lam.abs() < 1e-8
    lam_safe = torch.where(small, torch.ones_like(lam), lam)
    return torch.where(small, 1.0 + lam / 2.0, (s - 1.0) / lam_safe)


def sim3_expmap(xi):
    """xi = (omega, v, lambda): R = Exp(omega), s = e^lambda and
    t = a(lambda) J_l(omega) v, exact in rotation and scale (the chart only
    needs to be a retraction)."""
    w, v, lam = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    s = torch.exp(lam)
    t = _sim3_a(lam, s) * _matvec(so3.left_jacobian(w), v)
    return sim3_make(so3.expmap(w), t, s)


def sim3_logmap(g):
    w = so3.logmap(sim3_R(g))
    lam = torch.log(sim3_s(g))
    v = _matvec(so3.left_jacobian_inverse(w),
                sim3_t(g) / _sim3_a(lam, sim3_s(g)))
    return torch.cat([w, v, lam], dim=-1)


def sim3_retract(g, xi):
    return sim3_compose(g, sim3_expmap(xi))


def sim3_local(a, b):
    return sim3_logmap(sim3_compose(sim3_inverse(a), b))


SIM3 = manifolds.register(manifolds.Manifold(
    "sim3", 7, (3, 5), sim3_retract, sim3_local, sim3_identity))


# ---------------------------------------------------------------------------
# EssentialMatrix: [..., 3, 4] = [R | unit t], 5-dof
# ---------------------------------------------------------------------------

def essential_make(R, t_unit):
    return torch.cat([R, t_unit[..., None]], dim=-1)


def essential_matrix(e):
    """E = [t]_x R."""
    return so3.hat(e[..., 3]) @ e[..., :3]


def essential_retract(e, xi):
    return essential_make(so3.retract(e[..., :3], xi[..., :3]),
                          unit3_retract(e[..., 3], xi[..., 3:5]))


def essential_local(a, b):
    return torch.cat([so3.local(a[..., :3], b[..., :3]),
                      unit3_local(a[..., 3], b[..., 3])], dim=-1)


def _essential_identity(*, device, dtype):
    return essential_make(torch.eye(3, device=device, dtype=dtype),
                          torch.tensor([1.0, 0.0, 0.0], device=device,
                                       dtype=dtype))


ESSENTIAL = manifolds.register(manifolds.Manifold(
    "essential", 5, (3, 4), essential_retract, essential_local,
    _essential_identity))


def _homogeneous(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def essential_epipolar_error(e, pA, pB):
    """Algebraic epipolar error vA^T E vB, as [..., 1] (reference:
    EssentialMatrix::error)."""
    return _dot(_homogeneous(pA), _matvec(essential_matrix(e),
                                          _homogeneous(pB)))


# ---------------------------------------------------------------------------
# OrientedPlane3: [..., 4] = (unit normal, distance), 3-dof
# ---------------------------------------------------------------------------

def plane_retract(p, xi):
    return torch.cat([unit3_retract(p[..., :3], xi[..., :2]),
                      p[..., 3:4] + xi[..., 2:3]], dim=-1)


def plane_local(p, q):
    return torch.cat([unit3_local(p[..., :3], q[..., :3]),
                      q[..., 3:4] - p[..., 3:4]], dim=-1)


def _plane_identity(*, device, dtype):
    return torch.tensor([0.0, 0.0, 1.0, 0.0], device=device, dtype=dtype)


ORIENTED_PLANE = manifolds.register(manifolds.Manifold(
    "oriented_plane3", 3, (4,), plane_retract, plane_local,
    _plane_identity))


def plane_transform(plane, pose):
    """The plane in the frame of `pose` [..., 3, 4] (reference:
    OrientedPlane3::transform): n' = R^T n, d' = d - n . t."""
    n = plane[..., :3]
    R, t = pose[..., :3], pose[..., 3]
    return torch.cat([_matvec(R.transpose(-1, -2), n),
                      plane[..., 3:4] - _dot(n, t)], dim=-1)


# ---------------------------------------------------------------------------
# Line3: [..., 3, 4] = [R | (a, b, 0)], 4-dof
# ---------------------------------------------------------------------------

def line3_make(R, a, b):
    """a and b of shape [...]."""
    col = torch.stack([a, b, torch.zeros_like(a)], dim=-1)
    return torch.cat([R, col[..., None]], dim=-1)


def line3_retract(l, xi):
    """xi = (w1, w2, da, db): rotate about the two axes orthogonal to the
    line, shift (a, b) (reference: Line3::retract)."""
    w = torch.cat([xi[..., :2], torch.zeros_like(xi[..., :1])], dim=-1)
    return line3_make(l[..., :3] @ so3.expmap(w), l[..., 0, 3] + xi[..., 2],
                      l[..., 1, 3] + xi[..., 3])


def line3_local(l1, l2):
    w = so3.logmap(l1[..., :3].transpose(-1, -2) @ l2[..., :3])
    return torch.cat([w[..., :2], (l2[..., :2, 3] - l1[..., :2, 3])],
                     dim=-1)


def _line3_identity(*, device, dtype):
    z = torch.zeros((), device=device, dtype=dtype)
    return line3_make(torch.eye(3, device=device, dtype=dtype), z, z)


LINE3 = manifolds.register(manifolds.Manifold(
    "line3", 4, (3, 4), line3_retract, line3_local, _line3_identity))


def line3_point(l, t):
    """The point at parameter t [...] on the line (direction R e_z)."""
    R = l[..., :3]
    base = _matvec(R, torch.cat([l[..., :2, 3],
                                 torch.zeros_like(l[..., :1, 3])], dim=-1))
    return base + t[..., None] * R[..., :, 2]


# ---------------------------------------------------------------------------
# SphericalCamera: unit-bearing measurements
# ---------------------------------------------------------------------------

def spherical_project(pose, point):
    """World point -> unit bearing in the camera frame."""
    pc = se3.transform_to(pose, point)
    return pc / _max(_norm(pc), 1e-12)


def spherical_reprojection_error(pose, point, measured_unit):
    """2-dof tangent error of the predicted bearing at the measured one
    (reference: SphericalCamera::reprojectionError)."""
    return unit3_local(measured_unit, spherical_project(pose, point))


# ---------------------------------------------------------------------------
# Sim(2): [..., 4] = (x, y, theta, s), tangent (u1, u2, theta, lambda)
# ---------------------------------------------------------------------------

def sim2_make(t, theta, s):
    """theta and s of shape [..., 1]."""
    return torch.cat([t, theta, s], dim=-1)


def sim2_t(g):
    return g[..., :2]


def sim2_theta(g):
    return g[..., 2:3]


def sim2_s(g):
    return g[..., 3:4]


def sim2_identity(*, device, dtype):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], device=device, dtype=dtype)


def sim2_compose(a, b):
    t = sim2_t(a) + sim2_s(a) * so2.rotate(sim2_theta(a)[..., 0], sim2_t(b))
    return sim2_make(t, sim2_theta(a) + sim2_theta(b), sim2_s(a) * sim2_s(b))


def sim2_inverse(a):
    sinv = 1.0 / sim2_s(a)
    t = -sinv * so2.unrotate(sim2_theta(a)[..., 0], sim2_t(a))
    return sim2_make(t, -sim2_theta(a), sinv)


def sim2_transform(g, p):
    return sim2_s(g) * so2.rotate(sim2_theta(g)[..., 0], p) + sim2_t(g)


def _sim2_V(theta, lam):
    """(X, Y) of V(theta, lambda) = [[X, -Y], [Y, X]] = (e^z - 1) / z with
    z = lambda + i theta, as [..., 1] each; the JAX package evaluates it in
    complex arithmetic, here it is written out in real arithmetic, with the
    same series 1 + z / 2 + z^2 / 6 below |z| = 1e-4."""
    r2 = lam * lam + theta * theta
    small = r2 < 1e-8
    one = torch.ones_like(r2)
    lam_s = torch.where(small, one, lam)
    th_s = torch.where(small, torch.zeros_like(theta), theta)
    r2_s = torch.where(small, one, r2)
    e = torch.exp(lam_s)
    nr, ni = e * torch.cos(th_s) - 1.0, e * torch.sin(th_s)
    X = torch.where(small, 1.0 + lam / 2.0 + (lam * lam - theta * theta) / 6.0,
                    (nr * lam_s + ni * th_s) / r2_s)
    Y = torch.where(small, theta / 2.0 + 2.0 * lam * theta / 6.0,
                    (ni * lam_s - nr * th_s) / r2_s)
    return X, Y


def sim2_expmap(xi):
    """xi = (u1, u2, theta, lambda) (reference: Similarity2::Expmap)."""
    theta, lam = xi[..., 2:3], xi[..., 3:4]
    X, Y = _sim2_V(theta, lam)
    u1, u2 = xi[..., 0:1], xi[..., 1:2]
    return sim2_make(torch.cat([X * u1 - Y * u2, Y * u1 + X * u2], dim=-1),
                     theta, torch.exp(lam))


def sim2_logmap(g):
    theta = so2.wrap(sim2_theta(g))
    lam = torch.log(sim2_s(g))
    X, Y = _sim2_V(theta, lam)
    det = X * X + Y * Y
    t1, t2 = g[..., 0:1], g[..., 1:2]
    return torch.cat([(X * t1 + Y * t2) / det, (-Y * t1 + X * t2) / det,
                      theta, lam], dim=-1)


def sim2_retract(g, xi):
    return sim2_compose(g, sim2_expmap(xi))


def sim2_local(a, b):
    return sim2_logmap(sim2_compose(sim2_inverse(a), b))


SIM2 = manifolds.register(manifolds.Manifold(
    "sim2", 4, (4,), sim2_retract, sim2_local, sim2_identity))


def sim2_align_pairs(src, dst):
    """Closed-form Sim(2) taking src [N, 2] onto dst [N, 2] (Umeyama;
    reference: Similarity2::Align)."""
    ms, md = src.mean(0), dst.mean(0)
    cs, cd = src - ms, dst - md
    Sxx = cd.T @ cs
    theta = torch.atan2(Sxx[1, 0] - Sxx[0, 1], Sxx[0, 0] + Sxx[1, 1])
    num = (torch.cos(theta) * (cd[:, 0] * cs[:, 0] + cd[:, 1] * cs[:, 1])
           + torch.sin(theta) * (cd[:, 1] * cs[:, 0]
                                 - cd[:, 0] * cs[:, 1])).sum()
    s = num / torch.clamp((cs * cs).sum(), min=1e-12)
    t = md - s * so2.rotate(theta, ms)
    return sim2_make(t, theta[None], s[None])
