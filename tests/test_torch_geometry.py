"""The port's geometry, m-estimators and problem data against the JAX
package, in float64 on the CPU: the same numpy inputs through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.geometry import cameras as jcam, se3 as jse3, so3 as jso3
from gtsam_personal_tpu.linear import noise as jnoise
from gtsam_personal_tpu.sfm import bal as jbal, synthetic as jsyn
from gtsam_personal_tpu_torch.geometry import cameras, se3, so3
from gtsam_personal_tpu_torch.linear import noise
from gtsam_personal_tpu_torch.sfm import bal, synthetic

ROBUST_KINDS = ("huber", "cauchy", "geman_mcclure", "tukey", "welsch", "fair",
                "dcs", "l2_with_dead_zone", "asymmetric_tukey",
                "asymmetric_cauchy")


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _rotvecs(rng, n=48):
    """Random axis-angle vectors: large, below 1e-4 (the Taylor branch,
    theta^2 < 1e-6) and exactly zero."""
    w = rng.normal(size=(n, 3))
    w[n // 3: 2 * n // 3] *= 1e-5 / np.linalg.norm(
        w[n // 3: 2 * n // 3], axis=1, keepdims=True)
    w[2 * n // 3: 2 * n // 3 + 3] *= 1e-9
    w[-1] = 0.0
    return w


def _poses(rng, n):
    xi = np.concatenate([rng.normal(size=(n, 3)), 3.0 * rng.normal(
        size=(n, 3))], axis=1)
    return np.asarray(jax.vmap(jse3.expmap)(jnp.asarray(xi)))


def test_so3_expmap():
    w = _rotvecs(np.random.default_rng(0))
    ref = np.asarray(jax.vmap(jso3.expmap)(jnp.asarray(w)))
    np.testing.assert_allclose(so3.expmap(_t(w)).numpy(), ref, rtol=1e-12,
                               atol=0)


def test_so3_left_jacobian():
    w = _rotvecs(np.random.default_rng(1))
    ref = np.asarray(jax.vmap(jso3.left_jacobian)(jnp.asarray(w)))
    np.testing.assert_allclose(so3.left_jacobian(_t(w)).numpy(), ref,
                               rtol=1e-12, atol=0)


def test_se3_expmap():
    rng = np.random.default_rng(2)
    xi = np.concatenate([_rotvecs(rng), rng.normal(size=(48, 3))], axis=1)
    ref = np.asarray(jax.vmap(jse3.expmap)(jnp.asarray(xi)))
    np.testing.assert_allclose(se3.expmap(_t(xi)).numpy(), ref, rtol=1e-12,
                               atol=0)


def test_se3_retract():
    rng = np.random.default_rng(3)
    p = _poses(rng, 48)
    xi = np.concatenate([_rotvecs(rng), 0.1 * rng.normal(size=(48, 3))],
                        axis=1)
    ref = np.asarray(jax.vmap(jse3.retract)(jnp.asarray(p), jnp.asarray(xi)))
    np.testing.assert_allclose(se3.retract(_t(p), _t(xi)).numpy(), ref,
                               rtol=1e-12, atol=0)


def test_se3_transform_to():
    rng = np.random.default_rng(4)
    p, pt = _poses(rng, 32), rng.normal(size=(32, 3))
    ref = np.asarray(jax.vmap(jse3.transform_to)(jnp.asarray(p),
                                                 jnp.asarray(pt)))
    np.testing.assert_allclose(se3.transform_to(_t(p), _t(pt)).numpy(), ref,
                               rtol=1e-12, atol=0)


def test_project_point():
    """Points in front, behind, and within 1e-8 of the image plane (the
    depth clamp), through random Cal3Bundler calibrations."""
    rng = np.random.default_rng(5)
    n = 40
    p = _poses(rng, n)
    pc = np.concatenate([rng.normal(size=(n, 2)), rng.uniform(
        1.0, 9.0, size=(n, 1))], axis=1)
    pc[-8:-4, 2] *= -1.0                      # behind the camera
    pc[-4:, 2] = [3e-9, -3e-9, 0.0, 2e-9]     # inside the clamp
    pt = np.einsum("nij,nj->ni", p[:, :, :3], pc) + p[:, :, 3]
    cal = np.stack([rng.uniform(300, 900, n), 1e-3 * rng.normal(size=n),
                    1e-5 * rng.normal(size=n)], axis=1)
    ref = np.asarray(jax.vmap(
        lambda a, b, c: jcam.project_point(a, b, c, "cal3bundler"))(
            jnp.asarray(p), jnp.asarray(pt), jnp.asarray(cal)))
    got = cameras.project_point(_t(p), _t(pt), _t(cal),
                                "cal3bundler").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    # the depths of the points built on the image plane are rounding noise
    # (~1e-16), which a relative tolerance alone cannot compare
    depth = np.asarray(jax.vmap(jcam.depth_of)(jnp.asarray(p),
                                               jnp.asarray(pt)))
    np.testing.assert_allclose(cameras.depth_of(_t(p), _t(pt)).numpy(),
                               depth, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("kind", ROBUST_KINDS)
def test_robust_weight_and_loss(kind):
    rng = np.random.default_rng(6)
    e = np.concatenate([np.abs(rng.normal(scale=5.0, size=64)),
                        -np.abs(rng.normal(scale=5.0, size=8)), [0.0, 3.0]])
    k = 3.0
    for jf, tf in ((jnoise.robust_weight, noise.robust_weight),
                   (jnoise.robust_loss, noise.robust_loss)):
        ref = np.asarray(jf(kind, jnp.asarray(e), k))
        np.testing.assert_allclose(tf(kind, _t(e), k).numpy(), ref,
                                   rtol=1e-12, atol=0)


def _assert_same_problem(a, b):
    for f in ("cam_poses", "cam_cals", "points", "obs_cam", "obs_point",
              "obs_uv"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_make_skewed_problem_bit_identical():
    kw = dict(num_cameras=29, num_points=300, mean_track=4.0, max_track=24,
              seed=5, cam_zipf=1.2)
    _assert_same_problem(synthetic.make_skewed_problem(**kw),
                         jsyn.make_skewed_problem(**kw))


def test_make_ring_problem_bit_identical():
    kw = dict(num_cameras=16, num_points=200, obs_per_point=4, seed=1)
    _assert_same_problem(synthetic.make_ring_problem(**kw),
                         jsyn.make_ring_problem(**kw))


def test_bal_write_load_roundtrip(tmp_path):
    """write_bal of the port is read back by both packages' load_bal to the
    same arrays, and they match the problem written."""
    prob = synthetic.make_ring_problem(num_cameras=6, num_points=20,
                                       obs_per_point=3, seed=2)
    path = tmp_path / "ring.txt"
    bal.write_bal(path, prob)
    got, ref = bal.load_bal(path), jbal.load_bal(path)
    _assert_same_problem(got, ref)
    np.testing.assert_allclose(got.cam_poses, prob.cam_poses, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_array_equal(got.obs_cam, prob.obs_cam)
    np.testing.assert_allclose(got.obs_uv, prob.obs_uv, rtol=1e-15)


def test_load_bundler_matches(tmp_path):
    path = tmp_path / "tiny.out"
    path.write_text(
        "# Bundle file v0.3\n2 2\n"
        "500 0.01 -0.001\n1 0 0\n0 1 0\n0 0 1\n0 0 0\n"
        "450 0 0\n0.8 -0.6 0\n0.6 0.8 0\n0 0 1\n0.1 0.2 0.3\n"
        "1 2 -5\n255 0 0\n2 0 0 12.5 -3.0 1 1 -4.5 7.25\n"
        "-1 0.5 -6\n0 255 0\n1 1 3 2.0 1.0\n")
    got, ref = bal.load_bundler(path), jbal.load_bundler(path)
    _assert_same_problem(got, ref)
    assert got.num_observations == 3
