"""The port's constrained optimization (nonlinear/constrained.py) and misc
factors (nonlinear/misc.py: linear container, functorized, white noise)
against the JAX package, in float64 on the CPU, on
tests/test_constrained_noise.py's toy constrained graph, the pose-2
example and tests/test_misc_factors.py's cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.graph import (FactorBatch as JBatch,
                                           FactorGraph as JGraph,
                                           GraphBuilder as JBuilder)
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.linear import noise as jnoise
from gtsam_personal_tpu.nonlinear import (constrained as jcon, misc as jmisc,
                                          optimizers as jopt)
from gtsam_personal_tpu.slam import factors as JF
from gtsam_personal_tpu_torch.core.graph import (FactorBatch, FactorGraph,
                                                 GraphBuilder)
from gtsam_personal_tpu_torch.core.values import Values, values_from_numpy
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import (constrained, misc,
                                                optimizers as opt)
from gtsam_personal_tpu_torch.slam import factors as F
from test_pose2slam import build_example
from test_torch_graph import port_graph, port_values

F64 = torch.float64


def _vals(blocks):
    return values_from_numpy(blocks, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def pose2_example():
    jgraph, jinitial, expected = build_example()
    return jgraph, jinitial, port_graph(jgraph), port_values(jinitial)


# -- constrained ---------------------------------------------------------------

def _prior(xs, meas):
    return xs[0] - meas["p"]


def _between(xs, meas):
    a, b = xs
    return (b - a) - meas["m"]


def _first_gap(xs, meas):
    """The equality (x1 - x0)[0] == 3."""
    a, b = xs
    return (b - a)[:1] - meas["c"]


def _toy(pkg):
    """test_constrained_noise.py's toy graph: priors pull x0 to (1, 1) and
    x1 to (-1, 0), a soft between on the second coordinate; the
    constraint (x1 - x0)[0] = 3 as a separate batch."""
    if pkg == "jax":
        B, G, NM, V = JBatch, JGraph, jnoise.NoiseModel, JValues
        t, ix = jnp.asarray, lambda a: jnp.asarray(a, dtype=jnp.int32)
    else:
        B, G, NM, V = FactorBatch, FactorGraph, NoiseModel, Values
        t, ix = (lambda a: torch.tensor(np.asarray(a), dtype=F64),
                 lambda a: torch.tensor(a))
    graph = G([
        B("prior0", _prior, ("r2",), 2, ix([[0]]), {"p": t([[1.0, 1.0]])},
          NM("diag", t([[2.0, 2.0]]))),
        B("prior1", _prior, ("r2",), 2, ix([[1]]), {"p": t([[-1.0, 0.0]])},
          NM("diag", t([[2.0, 2.0]]))),
        B("soft", _between, ("r2", "r2"), 2, ix([[0, 1]]),
          {"m": t([[3.0, 0.0]])}, NM("diag", t([[0.0, 2.0]])))])
    cons = [B("gap", _first_gap, ("r2", "r2"), 1, ix([[0, 1]]),
              {"c": t([[3.0]])}, NM("unit"))]
    return graph, cons, V({"r2": t(np.zeros((2, 2)))})


@pytest.mark.parametrize("method", ["penalty", "augmented_lagrangian"])
def test_constrained_matches(method):
    """The penalty and augmented Lagrangian outer loops: the estimate of
    the JAX package's to 1e-9, the constraint met to 1e-6 (the analytic
    first coordinates -1.5 and 1.5 of test_constrained_noise.py)."""
    graph, cons, vals = _toy("torch")
    jgraph, jcons, jvals = _toy("jax")
    values, res = getattr(constrained, f"optimize_{method}")(graph, vals,
                                                             cons)
    jvalues, jres = getattr(jcon, f"optimize_{method}")(jgraph, jvals, jcons)
    x = values["r2"].numpy()
    np.testing.assert_allclose(x, np.asarray(jvalues["r2"]), rtol=0,
                               atol=1e-9)
    assert constrained.constraint_violation(cons, values) < 1e-6
    np.testing.assert_allclose(x[:, 0], [-1.5, 1.5], atol=1e-5)
    np.testing.assert_allclose(res.error, jres.error, rtol=1e-9, atol=1e-12)


def test_nonlinear_equality_matches(pose2_example):
    """The pose-2 example with its prior replaced by nonlinear_equality at
    a shifted pose: LM lands where the JAX package's does, pose 0 pinned."""
    jgraph, jinit, graph, init = pose2_example
    pin = np.array([0.1, -0.2, 0.05])
    eq = constrained.nonlinear_equality("se2", 0, pin, device="cpu")
    jeq = jcon.nonlinear_equality("se2", 0, pin)
    res = opt.optimize_lm(FactorGraph(graph.batches[1:] + [eq]), init)
    jres = jopt.optimize_lm(JGraph(list(jgraph.batches[1:]) + [jeq]), jinit)
    got = res.values["se2"].numpy()
    np.testing.assert_allclose(got, np.asarray(jres.values["se2"]),
                               atol=1e-9)
    np.testing.assert_allclose(got[0], pin, atol=1e-6)


# -- misc factors --------------------------------------------------------------

def test_linear_container_matches():
    """test_misc_factors.py's case: GN on the wrapped factor is the linear
    least-squares solution in the anchor's tangent space."""
    rng = np.random.default_rng(0)
    A0, A1 = rng.normal(size=(3, 3)), rng.normal(size=(3, 3))
    b = rng.normal(size=3)
    anchor0, anchor1 = rng.normal(size=3), rng.normal(size=3)
    out = []
    for mod, fmod, B in ((misc, F, GraphBuilder()),
                         (jmisc, JF, JBuilder())):
        mod.add_linear_container(B, ["r3", "r3"], [0, 1], [A0, A1], b,
                                 [anchor0, anchor1])
        fmod.add_prior(B, "r3", 0, anchor0, F.diag_noise([1e-6] * 3))
        start = np.stack([anchor0, anchor1])
        if mod is misc:
            r = opt.optimize_gn(B.build(device="cpu", dtype=F64),
                                _vals({"r3": start}),
                                opt.Params(max_iterations=5))
        else:
            r = jopt.optimize_gn(B.build(), JValues({"r3": jnp.asarray(
                start)}), jopt.Params(max_iterations=5))
        out.append(np.asarray(r.values["r3"]))
    np.testing.assert_allclose(out[0], out[1], atol=1e-9)
    np.testing.assert_allclose(out[0][1], anchor1 + np.linalg.solve(A1, b),
                               atol=1e-6)


def _unary(x, lib):
    return lib.stack([x[0] ** 2 + x[1], x[1] * 3.0])


def test_functorized_unary_matches():
    res = []
    for lib, mod, B, z in ((torch, misc, GraphBuilder(), np.array([5.0, 6.0])),
                           (jnp, jmisc, JBuilder(), jnp.asarray([5.0, 6.0]))):
        B.add("func", mod.make_functorized_residual(lambda x: _unary(x, lib)),
              ("r2",), 2, [0], {"z": z}, {"kind": "unit"})
        if lib is torch:
            r = opt.optimize_lm(B.build(device="cpu", dtype=F64),
                                _vals({"r2": np.array([[1.0, 1.0]])}),
                                opt.Params(max_iterations=30))
        else:
            r = jopt.optimize_lm(B.build(), JValues({"r2": jnp.asarray(
                [[1.0, 1.0]])}), jopt.Params(max_iterations=30))
        res.append(np.asarray(r.values["r2"][0]))
    x = res[0]
    np.testing.assert_allclose([x[0] ** 2 + x[1], 3 * x[1]], [5.0, 6.0],
                               atol=1e-5)
    np.testing.assert_allclose(res[0], res[1], atol=1e-9)


def test_functorized_binary_matches():
    res = []
    for lib, mod, fmod, B in ((torch, misc, F, GraphBuilder()),
                              (jnp, jmisc, JF, JBuilder())):
        fn = lambda a, b, lib=lib: lib.atleast_1d((a * b).sum())
        B.add("func2", mod.make_functorized2_residual(fn), ("r2", "r2"), 1,
              [0, 1], {"z": np.array([2.0])}, {"kind": "unit"})
        fmod.add_prior(B, "r2", 0, np.array([1.0, 1.0]),
                       F.diag_noise([1e-3, 1e-3]))
        start = np.array([[1.0, 1.0], [0.5, 0.5]])
        if lib is torch:
            r = opt.optimize_lm(B.build(device="cpu", dtype=F64),
                                _vals({"r2": start}),
                                opt.Params(max_iterations=30))
        else:
            r = jopt.optimize_lm(B.build(), JValues({"r2": jnp.asarray(
                start)}), jopt.Params(max_iterations=30))
        res.append(np.asarray(r.values["r2"]))
    np.testing.assert_allclose(np.dot(res[0][0], res[0][1]), 2.0, atol=1e-4)
    np.testing.assert_allclose(res[0], res[1], atol=1e-9)


def test_white_noise_matches():
    """test_misc_factors.py's case: the ML mean and precision of 200 draws,
    and the JAX package's estimate to 1e-9."""
    rng = np.random.default_rng(1)
    z = rng.normal(loc=2.5, scale=0.5, size=200)
    mu_ml, tau_ml = misc.white_noise_mle(z)
    assert (mu_ml, tau_ml) == jmisc.white_noise_mle(z)
    params = dict(max_iterations=300, relative_error_tol=1e-12,
                  absolute_error_tol=1e-12)
    b, jb = GraphBuilder(), JBuilder()
    for zk in z:
        b.add("white_noise", misc.white_noise_residual, ("r1", "r1"), 2,
              [0, 1], {"z": np.asarray(float(zk)), "umax": np.log(1e8)},
              {"kind": "unit"})
        jb.add("white_noise", jmisc.white_noise_residual, ("r1", "r1"), 2,
               [0, 1], {"z": jnp.asarray(float(zk)),
                        "umax": jnp.asarray(np.log(1e8))}, {"kind": "unit"})
    res = opt.optimize_lm(b.build(device="cpu", dtype=F64),
                          _vals({"r1": np.zeros((2, 1))}), opt.Params(
                              **params))
    jres = jopt.optimize_lm(jb.build(), JValues({"r1": jnp.zeros((2, 1))}),
                            jopt.Params(**params))
    got = res.values["r1"].numpy()[:, 0]
    np.testing.assert_allclose(got, np.asarray(jres.values["r1"])[:, 0],
                               atol=1e-9)
    np.testing.assert_allclose(got[0], mu_ml, atol=1e-3)
    np.testing.assert_allclose(np.exp(got[1]), tau_ml, rtol=1e-2)
