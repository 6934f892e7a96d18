"""The port's SO(2)/SE(2) geometry, the SO(3)/SE(3) functions that the
manifold registry needs, and the registry itself, against the JAX package in
float64 on the CPU: the same numpy inputs through both, rtol 1e-12.

The JAX functions take one element and are batched with `jax.vmap`; the
port's take the batch as it is. Where a result's entries can cancel to zero
(a product of rotations, a difference of poses) an absolute tolerance of
that rounding is stated beside the call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core import manifolds as jman
from gtsam_personal_tpu.geometry import (se2 as jse2, se3 as jse3,
                                         so2 as jso2, so3 as jso3)
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.geometry import se2, se3, so2, so3

N = 48


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _close(got, ref, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=atol)


def _angles(rng, n=N):
    """Angles: generic, below 1e-5 (the Taylor branch, w^2 < 1e-10), exactly
    zero, and beyond pi (so that wrap has work to do)."""
    w = rng.uniform(-3.0, 3.0, size=n)
    w[n // 3: 2 * n // 3] = rng.uniform(-1e-5, 1e-5, size=n // 3)
    w[-4:] = [0.0, 4.0, -5.5, 1e-9]
    return w


def _se2_tangents(rng):
    return np.concatenate([rng.normal(size=(N, 2)), _angles(rng)[:, None]],
                          axis=1)


def _se2_poses(rng):
    return np.concatenate([3.0 * rng.normal(size=(N, 2)),
                           _angles(rng)[:, None]], axis=1)


def _rotvecs(rng, n=N):
    """Axis-angle vectors: generic, below 1e-5, and exactly zero."""
    w = rng.normal(size=(n, 3))
    w[n // 3: 2 * n // 3] *= 1e-6 / np.linalg.norm(
        w[n // 3: 2 * n // 3], axis=1, keepdims=True)
    w[-1] = 0.0
    return w


def _rotations(rng, n=N):
    """Rotations: generic, near the identity, and within 1e-6 of pi (on both
    sides of it, about axes whose largest component differs)."""
    w = _rotvecs(rng, n)
    axes = rng.normal(size=(12, 3))
    axes[:3] = np.eye(3) + 0.01 * rng.normal(size=(3, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    w[:12] = axes * (np.pi - rng.uniform(-1e-6, 1e-6, size=(12, 1)))
    w[12] = axes[0] * np.pi
    return np.asarray(jax.vmap(jso3.expmap)(jnp.asarray(w)))


def _se3_poses(rng, n=N):
    R = _rotations(rng, n)
    return np.concatenate([R, 3.0 * rng.normal(size=(n, 3, 1))], axis=2)


# --- SO(2) ------------------------------------------------------------------

def test_so2_all_functions():
    rng = np.random.default_rng(0)
    a, b = _angles(rng), _angles(rng)
    p = rng.normal(size=(N, 2))
    w = b[:, None]
    ja, jb, jp, jw = map(jnp.asarray, (a, b, p, w))
    ta, tb, tp, tw = map(_t, (a, b, p, w))
    _close(so2.wrap(ta), jax.vmap(jso2.wrap)(ja))
    _close(so2.expmap(tw), jax.vmap(jso2.expmap)(jw))
    _close(so2.logmap(ta), jax.vmap(jso2.logmap)(ja))
    _close(so2.compose(ta, tb), jax.vmap(jso2.compose)(ja, jb))
    _close(so2.inverse(ta), jax.vmap(jso2.inverse)(ja))
    _close(so2.between(ta, tb), jax.vmap(jso2.between)(ja, jb))
    _close(so2.matrix(ta), jax.vmap(jso2.matrix)(ja))
    _close(so2.rotate(ta, tp), jax.vmap(jso2.rotate)(ja, jp))
    _close(so2.unrotate(ta, tp), jax.vmap(jso2.unrotate)(ja, jp))
    _close(so2.retract(ta, tw), jax.vmap(jso2.retract)(ja, jw))
    _close(so2.local(ta, tb), jax.vmap(jso2.local)(ja, jb))
    assert so2.identity(device="cpu", dtype=torch.float64).shape == ()


# --- SE(2) ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["expmap", "logmap", "inverse", "adjoint",
                                  "translation", "rotation"])
def test_se2_unary(name):
    rng = np.random.default_rng(1)
    x = _se2_tangents(rng) if name == "expmap" else _se2_poses(rng)
    _close(getattr(se2, name)(_t(x)),
           jax.vmap(getattr(jse2, name))(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["compose", "between", "local"])
def test_se2_binary(name):
    rng = np.random.default_rng(2)
    a, b = _se2_poses(rng), _se2_poses(rng)
    # `local` of two nearby poses runs logmap's Taylor branch. Their
    # relative translation of ~1e-7 is a difference of coordinates of size
    # ~3 to ~10, each rounded to ~1e-15: that is the absolute tolerance.
    b[:8] = a[:8] + 1e-7 * rng.normal(size=(8, 3))
    _close(getattr(se2, name)(_t(a), _t(b)),
           jax.vmap(getattr(jse2, name))(jnp.asarray(a), jnp.asarray(b)),
           atol=4e-15)


def test_se2_retract_and_points():
    rng = np.random.default_rng(3)
    p, xi, pt = _se2_poses(rng), _se2_tangents(rng), rng.normal(size=(N, 2))
    jp, jxi, jpt = map(jnp.asarray, (p, xi, pt))
    _close(se2.retract(_t(p), _t(xi)), jax.vmap(jse2.retract)(jp, jxi))
    _close(se2.make(_t(pt), _t(p[:, 2])),
           jax.vmap(jse2.make)(jpt, jp[:, 2]))
    for name in ("transform_from", "transform_to", "bearing", "range_to"):
        _close(getattr(se2, name)(_t(p), _t(pt)),
               jax.vmap(getattr(jse2, name))(jp, jpt))


def test_se2_small_angle_derivative_is_finite():
    """Forward-mode derivatives through expmap and logmap at w = 0 and at
    |w| < 1e-5: the unselected branch of each `where` holds no NaN."""
    xi = _t([[0.3, -0.2, 0.0], [0.1, 0.2, 3e-6], [1.0, 2.0, 0.7]])
    for fn, jfn in ((se2.expmap, jse2.expmap), (se2.logmap, jse2.logmap)):
        J = torch.func.vmap(torch.func.jacfwd(fn))(xi)
        ref = jax.vmap(jax.jacfwd(jfn))(jnp.asarray(xi.numpy()))
        assert torch.isfinite(J).all()
        _close(J, ref, atol=1e-15)


# --- SO(3) / SE(3) additions ------------------------------------------------

def test_so3_logmap_with_rotations_near_pi():
    """Includes rotations within 1e-6 of pi. There the axis comes from a
    square root of (1 + R_kk) / 2 and the angle from atan2 of a sine of
    1e-6 or less, so the comparison is absolute at 1e-12 rather than
    relative per component (a component of the axis may be ~0)."""
    R = _rotations(np.random.default_rng(4))
    got = so3.logmap(_t(R))
    ref = jax.vmap(jso3.logmap)(jnp.asarray(R))
    _close(got, ref, atol=1e-12)
    assert torch.isfinite(got).all()
    # and it inverts expmap on every branch
    np.testing.assert_allclose(so3.expmap(got).numpy(), R, atol=1e-9)


def test_so3_group_functions():
    rng = np.random.default_rng(5)
    R1, R2, w, p = (_rotations(rng), _rotations(rng), _rotvecs(rng),
                    rng.normal(size=(N, 3)))
    j1, j2, jw, jp = map(jnp.asarray, (R1, R2, w, p))
    t1, t2, tw, tp = map(_t, (R1, R2, w, p))
    _close(so3.vee(so3.hat(tw)), w)
    _close(so3.vee(t1), jax.vmap(jso3.vee)(j1))
    _close(so3.compose(t1, t2), jax.vmap(jso3.compose)(j1, j2))
    _close(so3.inverse(t1), jax.vmap(jso3.inverse)(j1))
    _close(so3.between(t1, t2), jax.vmap(jso3.between)(j1, j2), atol=1e-16)
    _close(so3.rotate(t1, tp), jax.vmap(jso3.rotate)(j1, jp), atol=1e-16)
    _close(so3.unrotate(t1, tp), jax.vmap(jso3.unrotate)(j1, jp), atol=1e-16)
    _close(so3.retract(t1, tw), jax.vmap(jso3.retract)(j1, jw), atol=1e-16)
    _close(so3.left_jacobian_inverse(tw),
           jax.vmap(jso3.left_jacobian_inverse)(jw))
    _close(so3.identity(device="cpu", dtype=torch.float64),
           jso3.identity(jnp.float64))


def test_so3_local():
    """local(R1, R2) = Log(R1^T R2): the product's rounding (1e-16) enters
    the logmap, whose condition grows towards pi, so generic pairs are held
    to atol 1e-12 on top of rtol 1e-12."""
    rng = np.random.default_rng(6)
    R1 = _rotations(rng)
    w = _rotvecs(rng)
    R2 = np.asarray(jax.vmap(jso3.retract)(jnp.asarray(R1), jnp.asarray(w)))
    got = so3.local(_t(R1), _t(R2))
    _close(got, jax.vmap(jso3.local)(jnp.asarray(R1), jnp.asarray(R2)),
           atol=1e-12)
    np.testing.assert_allclose(got.numpy(), w, atol=1e-9)


def test_se3_group_functions():
    rng = np.random.default_rng(7)
    a, b = _se3_poses(rng), _se3_poses(rng)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    _close(se3.make(ta[:, :, :3], ta[:, :, 3]),
           jax.vmap(jse3.make)(ja[:, :, :3], ja[:, :, 3]))
    _close(se3.rotation(ta), ja[:, :, :3])
    _close(se3.translation(ta), ja[:, :, 3])
    _close(se3.inverse(ta), jax.vmap(jse3.inverse)(ja), atol=1e-15)
    _close(se3.between(ta, tb), jax.vmap(jse3.between)(ja, jb), atol=1e-14)
    _close(se3.logmap(ta), jax.vmap(jse3.logmap)(ja), atol=1e-11)
    _close(se3.identity(device="cpu", dtype=torch.float64),
           jse3.identity(jnp.float64))


def test_se3_local_round_trip():
    rng = np.random.default_rng(8)
    a = _se3_poses(rng)
    xi = np.concatenate([_rotvecs(rng), rng.normal(size=(N, 3))], axis=1)
    b = np.asarray(jax.vmap(jse3.retract)(jnp.asarray(a), jnp.asarray(xi)))
    got = se3.local(_t(a), _t(b))
    _close(got, jax.vmap(jse3.local)(jnp.asarray(a), jnp.asarray(b)),
           atol=1e-11)
    np.testing.assert_allclose(got.numpy(), xi, atol=1e-8)


# --- the manifold registry --------------------------------------------------

def _points_of(name, rng):
    if name == "so2":
        return _angles(rng)
    if name == "se2":
        return _se2_poses(rng)
    if name == "so3":
        return _rotations(rng)
    if name == "se3":
        return _se3_poses(rng)
    return rng.normal(size=(N, manifolds.get(name).dim))


@pytest.mark.parametrize("name", ["so2", "se2", "so3", "se3", "r1", "r2",
                                  "r3", "r6", "r9", "point2", "point3",
                                  "vel3", "imu_bias"])
def test_manifold_retract_local_round_trip(name):
    rng = np.random.default_rng(9)
    m, jm = manifolds.get(name), jman.get(name)
    assert (m.name, m.dim, tuple(m.param_shape)) == (
        jm.name, jm.dim, tuple(jm.param_shape))
    x = _points_of(name, rng)
    d = 0.3 * rng.normal(size=(N, m.dim))
    d[: N // 3] *= 1e-6
    y = manifolds.batched_retract(m, _t(x), _t(d))
    jy = jman.batched_retract(jm, jnp.asarray(x), jnp.asarray(d))
    _close(y, jy, atol=1e-15)
    back = manifolds.batched_local(m, _t(x), y)
    _close(back, jman.batched_local(jm, jnp.asarray(x), jy), atol=1e-11)
    np.testing.assert_allclose(back.numpy(), d, atol=1e-8)
    ident = m.identity(device="cpu", dtype=torch.float64)
    assert tuple(ident.shape) == tuple(m.param_shape)
    _close(ident, jm.identity(jnp.float64))


def test_vector_space_and_user_manifold():
    """`vector_space` gets or creates; a manifold that a user registers with
    chart functions written for one element (Python indexing, as the JAX
    package's users write them) works in the batched calls."""
    m = manifolds.vector_space("test_landmark4", 4)
    assert m is manifolds.vector_space("test_landmark4", 4) and m.dim == 4

    def retract(p, xi):                 # unit-circle point, stored as (c, s)
        c, s = torch.cos(xi[0]), torch.sin(xi[0])
        return torch.stack([c * p[0] - s * p[1], s * p[0] + c * p[1]])

    def local(a, b):
        return torch.atan2(a[0] * b[1] - a[1] * b[0],
                           a[0] * b[0] + a[1] * b[1]).reshape(1)

    circle = manifolds.register(manifolds.Manifold(
        "test_circle", 1, (2,), retract, local,
        lambda *, device, dtype: torch.tensor([1.0, 0.0], device=device,
                                              dtype=dtype)))
    assert manifolds.get("test_circle") is circle
    rng = np.random.default_rng(10)
    ang, d = rng.uniform(-3, 3, size=N), rng.uniform(-1, 1, size=(N, 1))
    x = _t(np.stack([np.cos(ang), np.sin(ang)], axis=1))
    y = manifolds.batched_retract(circle, x, _t(d))
    np.testing.assert_allclose(
        y.numpy(), np.stack([np.cos(ang + d[:, 0]), np.sin(ang + d[:, 0])],
                            axis=1), atol=1e-14)
    np.testing.assert_allclose(manifolds.batched_local(circle, x, y).numpy(),
                               d, atol=1e-14)
