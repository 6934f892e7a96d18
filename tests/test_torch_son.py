"""The port's SO(n) (geometry/son.py), its forward-mode-safe small solve and
testing/numerical.py against the JAX package, in float64 on the CPU.

Inputs are numpy draws from fixed seeds, given to both packages. The
exponential map goes through `eigh`, whose eigenvectors are fixed only up
to phase, so it is compared as a matrix. The last tests are the guard of
ROADMAP queue 3 B1: `linearize`'s Jacobians through the Cayley charts of
`son5` and `sop5`, at a batch of 4 factors, against central differences."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.geometry import son as json_, so3 as jso3
from gtsam_personal_tpu.testing import numerical as jnum
from gtsam_personal_tpu_torch.core.graph import FactorBatch
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.geometry import son, so3
from gtsam_personal_tpu_torch.linear.linearize import linearize_batch
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.sfm import shonan
from gtsam_personal_tpu_torch.testing.numerical import numerical_jacobian

NS = [3, 4, 5, 6, 7]
B1_BATCH = 4


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _draw(n, seed, scale=0.3):
    return scale * np.random.default_rng(seed).normal(
        size=son.tangent_dim(n))


@pytest.mark.parametrize("n", [2] + NS)
def test_hat_vee_match(n):
    xi = np.random.default_rng(n).normal(size=son.tangent_dim(n))
    W = son.hat(_t(xi), n)
    np.testing.assert_array_equal(W.numpy(), np.asarray(json_.hat(
        jnp.asarray(xi), n)))
    np.testing.assert_allclose(W.numpy(), -W.numpy().T, atol=1e-15)
    np.testing.assert_allclose(son.vee(W).numpy(), xi, atol=1e-14)
    np.testing.assert_allclose(son.vee(W).numpy(),
                               np.asarray(json_.vee(jnp.asarray(W.numpy()))),
                               atol=1e-15)


def test_hat_matches_so3():
    xi = np.array([0.3, -0.2, 0.5])
    np.testing.assert_allclose(son.hat(_t(xi), 3).numpy(),
                               so3.hat(_t(xi)).numpy(), atol=1e-15)
    np.testing.assert_allclose(son.vee(so3.hat(_t(xi))).numpy(), xi,
                               atol=1e-15)


@pytest.mark.parametrize("n", NS)
def test_expmap_matches(n):
    """exp as a matrix (the eigenvectors are fixed only up to phase): equal
    to the JAX package's to 1e-12, orthogonal with det 1, and at n = 3
    equal to Rodrigues."""
    xi = _draw(n, n + 10)
    R = son.expmap(_t(xi), n).numpy()
    np.testing.assert_allclose(R, np.asarray(json_.expmap(jnp.asarray(xi),
                                                          n)), atol=1e-12)
    np.testing.assert_allclose(R @ R.T, np.eye(n), atol=1e-12)
    assert abs(np.linalg.det(R) - 1.0) < 1e-10
    if n == 3:
        np.testing.assert_allclose(R, so3.expmap(_t(xi)).numpy(),
                                   atol=1e-12)


@pytest.mark.parametrize("n", NS)
def test_logmap_matches(n):
    xi = _draw(n, n + 20, scale=0.4)
    R = son.expmap(_t(xi), n)
    got = son.logmap(R).numpy()
    np.testing.assert_allclose(got, xi, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(json_.logmap(
        jnp.asarray(R.numpy()))), atol=1e-12)


@pytest.mark.parametrize("n", NS)
def test_cayley_retract_local_match(n):
    """The Cayley chart of son<n> and sop<n> against the JAX package's, to
    1e-12, and local inverting retract."""
    m, jm = son.register_son(n), json_.register_son(n)
    sm, jsm = shonan.make_sop_manifold(n), _jax_sop(n)
    R = son.expmap(_t(_draw(n, n + 30)), n)
    xi = _t(0.2 * np.random.default_rng(n + 40).normal(
        size=son.tangent_dim(n)))
    jR, jxi = jnp.asarray(R.numpy()), jnp.asarray(xi.numpy())
    for mm, jj in ((m, jm), (sm, jsm)):
        S = mm.retract(R, xi)
        np.testing.assert_allclose(S.numpy(), np.asarray(jj.retract(jR, jxi)),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(S.numpy() @ S.numpy().T, np.eye(n),
                                   atol=1e-12)
        back = mm.local(R, S)
        np.testing.assert_allclose(back.numpy(), xi.numpy(), atol=1e-10)
        np.testing.assert_allclose(
            back.numpy(), np.asarray(jj.local(jR, jnp.asarray(S.numpy()))),
            rtol=0, atol=1e-12)
    np.testing.assert_allclose(son.cayley(son.hat(xi, n)).numpy(), np.asarray(
        json_.cayley(json_.hat(jxi, n))), rtol=0, atol=1e-12)


def _jax_sop(p):
    from gtsam_personal_tpu.sfm import shonan as jshonan
    return jshonan.make_sop_manifold(p)


def test_identity_and_group_ops():
    m = son.register_son(5)
    eye = m.identity(device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(eye.numpy(), np.eye(5))
    assert son.SO4.name == "son4" and son.SO4.dim == 6
    A = son.expmap(_t(_draw(5, 1)), 5)
    B = son.expmap(_t(_draw(5, 2)), 5)
    jA, jB = jnp.asarray(A.numpy()), jnp.asarray(B.numpy())
    for f, jf in ((son.compose, json_.compose), (son.between,
                                                 json_.between)):
        np.testing.assert_allclose(f(A, B).numpy(), np.asarray(jf(jA, jB)),
                                   atol=1e-15)
    np.testing.assert_allclose(son.inverse(A).numpy(),
                               np.asarray(json_.inverse(jA)), atol=0)


def test_numerical_jacobian_matches():
    """The port's copy of numerical_jacobian against the JAX package's: on
    SO(3) through a retract chart (the probe of the tangent dimension) and
    with the default additive chart."""
    R0 = so3.expmap(_t([0.2, -0.4, 0.3])).numpy()
    p = np.array([1.0, -2.0, 0.5])

    def f(R):
        return R @ p

    # the probe of the tangent dimension tries lengths until retract
    # accepts one: make both charts refuse every length but 3
    def retract(R, d):
        assert d.shape == (3,)
        return R @ so3.expmap(_t(d)).numpy()

    def jretract(R, d):
        assert d.shape == (3,)
        return R @ np.asarray(jso3.expmap(jnp.asarray(d)))

    got = numerical_jacobian(f, R0, retract)
    want = jnum.numerical_jacobian(f, R0, jretract)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, -R0 @ so3.hat(_t(p)).numpy(), atol=1e-8)
    g = lambda x: np.array([x[0] ** 2 * x[1], np.sin(x[1])])
    x0 = np.array([0.7, -1.3])
    np.testing.assert_allclose(numerical_jacobian(g, x0),
                               jnum.numerical_jacobian(g, x0), atol=1e-12)


# -- ROADMAP queue 3 B1: differentiated p x p solves under vmap(jacfwd) ------

def _b1_batch(group, n, residual, seed):
    """B1_BATCH factors of `residual` over 2 * B1_BATCH points of `group`,
    each factor on its own pair."""
    rng = np.random.default_rng(seed)
    d = son.tangent_dim(n)
    pts = son.expmap(_t(0.4 * rng.normal(size=(2 * B1_BATCH, d))), n)
    meas = son.expmap(_t(0.3 * rng.normal(size=(B1_BATCH, d))), n)
    idx = torch.arange(2 * B1_BATCH).reshape(B1_BATCH, 2)
    batch = FactorBatch("b1", residual, (group, group), residual.rdim, idx,
                        {"M": meas}, NoiseModel("unit"))
    return batch, Values({group: pts})


def _chart_residual(m):
    """local(Xi M, Xj): the chart's solve in the residual as well."""
    def residual(xs, meas):
        Xi, Xj = xs
        return m.local(Xi @ meas["M"], Xj)
    residual.rdim = m.dim
    return residual


def _frobenius_residual(n):
    def residual(xs, meas):
        Xi, Xj = xs
        return (Xj - Xi @ meas["M"]).reshape(n * n)
    residual.rdim = n * n
    return residual


@pytest.mark.parametrize("group,resname", [
    ("son5", "chart"), ("sop5", "chart"), ("sop5", "frobenius")])
def test_linearize_jacobian_b1_guard(group, resname):
    """linearize's Jacobians of B1_BATCH factors at once, every slot of
    every factor, against central differences through the retraction, to
    1e-7. With `torch.linalg.solve` in the Cayley charts in place of
    son.solve_small, every factor but the first comes out wrong."""
    n = 5
    m = son.register_son(n) if group == "son5" else \
        shonan.make_sop_manifold(n)
    residual = (_chart_residual(m) if resname == "chart"
                else _frobenius_residual(n))
    batch, values = _b1_batch(group, n, residual, seed=7)
    lb = linearize_batch(batch, values)
    pts = values[group]
    for k in range(B1_BATCH):
        Xi, Xj = pts[2 * k], pts[2 * k + 1]
        M = batch.meas["M"][k]
        for s in range(2):
            def f(d, s=s):
                xs = [Xi, Xj]
                xs[s] = m.retract(xs[s], _t(d))
                return residual(tuple(xs), {"M": M}).numpy()
            num = numerical_jacobian(f, np.zeros(m.dim))
            np.testing.assert_allclose(lb.Js[s][k].numpy(), num, rtol=0,
                                       atol=1e-7, err_msg=f"factor {k} "
                                       f"slot {s}")


def test_solve_small_rules():
    """solve_small's value, its forward rule under vmap(jacfwd) and its
    reverse rule against the plain solve's (reverse mode is right in
    torch) on a batch of 4."""
    rng = np.random.default_rng(3)
    A = _t(rng.normal(size=(4, 5, 5)) + 5 * np.eye(5))
    B = _t(rng.normal(size=(4, 5, 2)))
    np.testing.assert_allclose(son.solve_small(A, B).numpy(),
                               torch.linalg.solve(A, B).numpy(), atol=1e-14)
    J = torch.func.vmap(torch.func.jacfwd(son.solve_small, argnums=(0, 1)))(
        A, B)
    Jr = torch.func.vmap(torch.func.jacrev(torch.linalg.solve,
                                           argnums=(0, 1)))(A, B)
    for a, b in zip(J, Jr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    Jb = torch.func.vmap(torch.func.jacrev(son.solve_small, argnums=(0, 1)))(
        A, B)
    for a, b in zip(Jb, Jr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
