"""The port's Kalman filters (linear/kalman.py), LP/QP solvers
(linear/lpqp.py) and samplers (linear/sampler.py) against the JAX
package's, in float64 on the CPU: kf_run on examples/parity_suite.py's
easyPoint2 filter, the EKF on SE(2), tests/test_basis_lpqp.py:55-88's five
LP/QP cases, and tests/test_utils_averaging.py:198-216's two sampler cases
(the deterministic part of each draw on the JAX key's random numbers, and
the statistics of a torch.Generator's draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.geometry import se2 as jse2
from gtsam_personal_tpu.linear import kalman as jkalman
from gtsam_personal_tpu.linear import lpqp as jlpqp
from gtsam_personal_tpu.linear import noise as jnoise, sampler as jsampler
from gtsam_personal_tpu_torch.geometry import se2
from gtsam_personal_tpu_torch.linear import kalman, lpqp, noise, sampler

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


# --- Kalman -----------------------------------------------------------------

def test_kf_run_easy_point2():
    """easyPoint2KalmanFilter.cpp: a Point2 moving right a unit a step,
    three predict/update cycles; the final state (3, 0) with the closed-form
    covariance, equal to the JAX filter's."""
    eye = np.eye(2)
    us = np.tile([1.0, 0.0], (3, 1))
    zs = np.array([[1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])
    args = (eye, eye, 0.01 * eye, eye, 0.0625 * eye, us, zs)
    final, means = kalman.kf_run(kalman.GaussianState(_t(np.zeros(2)),
                                                      _t(0.01 * eye)),
                                 *map(_t, args))
    jfinal, jmeans = jkalman.kf_run(jkalman.GaussianState(
        jnp.zeros(2), 0.01 * jnp.eye(2)), *map(jnp.asarray, args))
    x, P = np.zeros(2), 0.01 * eye           # the closed form
    for u, z in zip(us, zs):
        x, P = x + u, P + 0.01 * eye
        K = P @ np.linalg.inv(P + 0.0625 * eye)
        x, P = x + K @ (z - x), (eye - K) @ P
    np.testing.assert_allclose(final.mean.numpy(), [3.0, 0.0], atol=1e-10)
    np.testing.assert_allclose(final.cov.numpy(), P, atol=1e-10)
    np.testing.assert_allclose(final.mean.numpy(), np.asarray(jfinal.mean),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(final.cov.numpy(), np.asarray(jfinal.cov),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), rtol=0,
                               atol=1e-14)


def test_ekf_se2():
    """Five predict/update cycles of an SE(2) EKF (odometry motion, a
    position measurement): the port's state equals the JAX filter's."""
    rng = np.random.default_rng(4)
    odo = np.array([1.0, 0.1, 0.2])
    Q, R = np.diag([0.01, 0.01, 0.004]), 0.05 * np.eye(2)
    zs = rng.normal(size=(5, 2))
    ekf = kalman.ExtendedKalmanFilter("se2", _t([0.1, -0.2, 0.3]),
                                      _t(0.1 * np.eye(3)))
    jekf = jkalman.ExtendedKalmanFilter("se2", jnp.asarray([0.1, -0.2, 0.3]),
                                        0.1 * jnp.eye(3))
    for z in zs:
        ekf.predict(lambda x: se2.compose(x, _t(odo)), _t(Q))
        jekf.predict(lambda x: jse2.compose(x, jnp.asarray(odo)),
                     jnp.asarray(Q))
        ekf.update(lambda x: x[:2], _t(z), _t(R))
        jekf.update(lambda x: x[:2], jnp.asarray(z), jnp.asarray(R))
    np.testing.assert_allclose(ekf.state.mean.numpy(),
                               np.asarray(jekf.state.mean), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ekf.state.cov.numpy(),
                               np.asarray(jekf.state.cov), rtol=0,
                               atol=1e-12)


# --- LP / QP (tests/test_basis_lpqp.py:55-88) --------------------------------

QP_CASES = {
    "unconstrained": (dict(G=np.diag([2.0, 4.0]), g=np.array([-2.0, -4.0])),
                      [1.0, 1.0], 1e-8),
    "equality_constrained": (dict(G=2 * np.eye(2), g=np.zeros(2),
                                  A_eq=np.array([[1.0, 1.0]]),
                                  b_eq=np.array([1.0])), [0.5, 0.5], 1e-8),
    "inequality_active": (dict(G=2 * np.eye(2), g=np.array([-4.0, -4.0]),
                               A_in=np.array([[1.0, 1.0]]),
                               b_in=np.array([2.0])), [1.0, 1.0], 1e-6),
    "inequality_inactive": (dict(G=2 * np.eye(2), g=np.array([-4.0, -4.0]),
                                 A_in=np.array([[1.0, 1.0]]),
                                 b_in=np.array([10.0])), [2.0, 2.0], 1e-6),
}


@pytest.mark.parametrize("name", list(QP_CASES))
def test_qp(name):
    kw, x, atol = QP_CASES[name]
    res = lpqp.solve_qp(**kw)
    assert res.converged
    np.testing.assert_allclose(res.x, x, atol=atol)
    ref = jlpqp.solve_qp(**kw)
    assert (res.iterations, res.converged) == (ref.iterations, ref.converged)
    np.testing.assert_array_equal(res.active, ref.active)
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-14)
    # tensors are taken as they are, on the host in float64
    tres = lpqp.solve_qp(**{k: torch.tensor(v, dtype=torch.float32)
                            for k, v in kw.items()})
    np.testing.assert_allclose(tres.x, x, atol=atol)


def test_lp_box():
    kw = dict(A_in=np.array([[1.0, 0], [0, 1.0], [-1.0, 0], [0, -1.0]]),
              b_in=np.array([1.0, 1.0, 0.0, 0.0]))
    res = lpqp.solve_lp(np.array([-1.0, -2.0]), **kw)
    assert res.converged
    np.testing.assert_allclose(res.x, [1.0, 1.0], atol=1e-5)
    ref = jlpqp.solve_lp(np.array([-1.0, -2.0]), **kw)
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-14)


# --- samplers (tests/test_utils_averaging.py:198-216) -------------------------

def test_noise_sampler_covariance():
    cov = np.array([[2.0, 0.5], [0.5, 1.0]])
    model = noise.covariance(cov, device="cpu", dtype=F64)
    key = jax.random.PRNGKey(0)
    jv = np.asarray(jsampler.sample_noise(key, jnoise.covariance(cov),
                                          (4000,)))
    z = np.asarray(jax.random.normal(key, (4000, 2), dtype=jnp.float64))
    v = sampler.noise_from_standard(model, _t(z)).numpy()
    np.testing.assert_allclose(v, jv, rtol=1e-10, atol=1e-12)
    gen = torch.Generator().manual_seed(0)
    vt = sampler.sample_noise(gen, model, (4000,)).numpy()
    assert vt.shape == (4000, 2)
    for sample in (v, vt):
        np.testing.assert_allclose(np.cov(sample.T), cov, atol=0.15)
    diag = noise.sigmas([0.5, 2.0], device="cpu", dtype=F64)
    vd = sampler.sample_noise(gen, diag, (4000,)).numpy()
    np.testing.assert_allclose(vd.std(axis=0), [0.5, 2.0], rtol=0.1)
    with pytest.raises(ValueError):
        sampler.sample_noise(gen, noise.unit())
    assert tuple(sampler.sample_standard(gen, 3, (5,)).shape) == (5, 3)


def test_weighted_sampling():
    w = np.array([0.01, 0.01, 10.0, 0.01])
    counts = np.zeros(4)
    for s in range(100):
        key = jax.random.PRNGKey(s)
        u = np.asarray(jax.random.uniform(key, w.shape, minval=1e-12,
                                          maxval=1.0))
        idx = sampler.weighted_keys_order(_t(w), _t(u), 2).numpy()
        ref = np.asarray(jsampler.weighted_sample_without_replacement(
            key, w, 2))
        np.testing.assert_array_equal(idx, ref)
        counts[idx[0]] += 1
    assert counts[2] > 80
    gen = torch.Generator().manual_seed(0)
    counts[:] = 0
    for _ in range(100):
        counts[int(sampler.weighted_sample_without_replacement(
            gen, _t(w), 1)[0])] += 1
    assert counts[2] > 80
    idx = sampler.weighted_sample_without_replacement(gen, _t(w), 4)
    assert sorted(idx.tolist()) == [0, 1, 2, 3]
