"""The port's nonlinear breadth against the JAX package, in float64 on the
CPU: marginals and GNC, on tests/test_shonan_gnc.py's problems, every
graph built from the same numbers in both packages. Dogleg and NCG are in
test_torch_dogleg.py, constrained optimization and the misc factors in
test_torch_constrained_misc.py, the tools in test_torch_tools_breadth.py
(files apart, to keep each file's CPU time under a minute)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.graph import (FactorGraph as JGraph,
                                           GraphBuilder as JBuilder)
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.geometry import se2 as jse2
from gtsam_personal_tpu.nonlinear import gnc as jgnc, marginals as jmarg
from gtsam_personal_tpu.slam import factors as JF
from gtsam_personal_tpu_torch.core.graph import FactorGraph, GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.nonlinear import gnc, marginals
from gtsam_personal_tpu_torch.slam import factors as F

F64 = torch.float64


def _vals(blocks):
    return values_from_numpy(blocks, device="cpu", dtype=F64)


# -- marginals ---------------------------------------------------------------

def _chain(mods, builders):
    for mod, b in zip(mods, builders):
        mod.add_prior(b, "se2", 0, np.zeros(3), F.diag_noise([0.1] * 3))
        for i in range(3):
            mod.add_between(b, "se2", i, i + 1, np.array([1.0, 0, 0]),
                            F.diag_noise([0.1, 0.1, 0.1]))


def test_prior_only_covariance():
    b, jb = GraphBuilder(), JBuilder()
    for mod, bb in ((F, b), (JF, jb)):
        mod.add_prior(bb, "se2", 0, np.zeros(3), F.diag_noise([0.3, 0.3,
                                                               0.1]))
    m = marginals.Marginals(b.build(device="cpu", dtype=F64),
                            _vals({"se2": np.zeros((1, 3))}))
    cov = m.marginal_covariance("se2", 0).numpy()
    np.testing.assert_allclose(np.diag(cov), [0.09, 0.09, 0.01], atol=1e-10)
    jm = jmarg.Marginals(jb.build(), JValues({"se2": jnp.zeros((1, 3))}))
    np.testing.assert_allclose(cov, np.asarray(jm.marginal_covariance(
        "se2", 0)), atol=1e-15)


@pytest.mark.parametrize("damping", [0.0, 1e-3])
def test_chain_marginals_match(damping):
    """test_shonan_gnc.py's growing chain: every block, a joint block, the
    information and all_marginal_covariances against the JAX package to
    1e-12; the uncertainty grows along the chain."""
    b, jb = GraphBuilder(), JBuilder()
    _chain((F, JF), (b, jb))
    poses = np.zeros((4, 3))
    poses[:, 0] = np.arange(4)
    graph, jgraph = b.build(device="cpu", dtype=F64), jb.build()
    vals, jvals = _vals({"se2": poses}), JValues({"se2": jnp.asarray(poses)})
    m = marginals.Marginals(graph, vals, damping)
    jm = jmarg.Marginals(jgraph, jvals, damping)
    np.testing.assert_allclose(m.cov.numpy(), np.asarray(jm.cov), atol=1e-12)
    t = [np.trace(m.marginal_covariance("se2", i).numpy()) for i in range(4)]
    assert t[3] > t[0]
    keys = [("se2", 3), ("se2", 1)]
    np.testing.assert_allclose(m.joint_marginal_covariance(keys).numpy(),
                               np.asarray(jm.joint_marginal_covariance(keys)),
                               atol=1e-12)
    np.testing.assert_allclose(m.marginal_information("se2", 2).numpy(),
                               np.asarray(jm.marginal_information("se2", 2)),
                               rtol=1e-10)
    np.testing.assert_allclose(
        marginals.all_marginal_covariances(graph, vals, "se2",
                                           damping).numpy(),
        np.asarray(jmarg.all_marginal_covariances(jgraph, jvals, "se2",
                                                  damping)), atol=1e-12)


# -- GNC -----------------------------------------------------------------------

def _gnc_problem():
    """test_shonan_gnc.py's pose graph: 12 poses, a good closure and two
    outlier closures in the last batch; (port graph, JAX graph, initial
    poses, truth)."""
    rng = np.random.default_rng(4)
    n = 12
    truth = np.zeros((n, 3))
    for i in range(1, n):
        truth[i] = np.asarray(jse2.compose(jnp.asarray(truth[i - 1]),
                                           jnp.asarray([1.0, 0.0, 0.3])))
    pb, jpb, bb, jbb = GraphBuilder(), JBuilder(), GraphBuilder(), JBuilder()
    for mod, b in ((F, pb), (JF, jpb)):
        mod.add_prior(b, "se2", 0, truth[0], F.diag_noise([0.1, 0.1, 0.05]))
    odo = [np.asarray(jse2.between(jnp.asarray(truth[i]),
                                   jnp.asarray(truth[i + 1])))
           + rng.normal(scale=0.005, size=3) for i in range(n - 1)]
    closure = np.asarray(jse2.between(jnp.asarray(truth[0]),
                                      jnp.asarray(truth[n - 1])))
    noise = F.diag_noise([0.05, 0.05, 0.02])
    for mod, b in ((F, bb), (JF, jbb)):
        for i in range(n - 1):
            mod.add_between(b, "se2", i, i + 1, odo[i], noise)
        mod.add_between(b, "se2", 0, n - 1, closure, noise)
        mod.add_between(b, "se2", 1, 8, np.array([5.0, -3.0, 1.5]), noise)
        mod.add_between(b, "se2", 2, 9, np.array([-4.0, 2.0, -2.0]), noise)
    graph = FactorGraph(pb.build(device="cpu", dtype=F64).batches
                        + bb.build(device="cpu", dtype=F64).batches)
    jgraph = JGraph(list(jpb.build().batches) + list(jbb.build().batches))
    init = truth + rng.normal(scale=0.05, size=truth.shape)
    return graph, jgraph, init, truth


@pytest.mark.parametrize("loss", ["tls", "gm"])
def test_gnc_matches(loss):
    """The weights (to 1e-8) and the estimate (to 1e-8) of the JAX
    package's GNC; with TLS the two outliers are rejected as in
    test_shonan_gnc.py."""
    graph, jgraph, init, truth = _gnc_problem()
    values, w, res = gnc.optimize_gnc(graph, _vals({"se2": init}), 1,
                                      gnc.GncParams(loss_type=loss))
    jvalues, jw, jres = jgnc.optimize_gnc(
        jgraph, JValues({"se2": jnp.asarray(init)}), 1,
        jgnc.GncParams(loss_type=loss))
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-8)
    np.testing.assert_allclose(values["se2"].numpy(),
                               np.asarray(jvalues["se2"]), atol=1e-8)
    if loss == "tls":
        assert w[-1] < 0.1 and w[-2] < 0.1 and w[:-2].min() > 0.9
        np.testing.assert_allclose(values["se2"].numpy()[:, :2],
                                   truth[:, :2], atol=0.05)
