"""The port's concurrent filter and smoother (nonlinear/concurrent.py)
against the JAX package, in float64 on the CPU, on tests/test_concurrent.py's
cases.

The JAX package's filter is its fixed-lag smoother, which compiles a new
program at every update (seconds an update on a CPU), so the
stream is held to the JAX test's rules against the JAX package's batch
optimum of the same factors, and the summarized factor that synchronize()
hands the filter to the JAX package's `_smoother_summary` of the same
graph, point, boundary and excluded window."""

import jax.numpy as jnp
import numpy as np
import torch

from gtsam_personal_tpu.core.graph import GraphBuilder as JBuilder
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.geometry import se2 as jse2
from gtsam_personal_tpu.nonlinear import concurrent as jcon
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.slam import factors as JF
from gtsam_personal_tpu_torch.core.graph import FactorGraph, GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.nonlinear import concurrent, optimizers as opt
from gtsam_personal_tpu_torch.nonlinear.marginals import Marginals
from gtsam_personal_tpu_torch.slam import factors as F

F64 = torch.float64
PRIOR = F.diag_noise([0.1, 0.1, 0.05])
ODO = F.diag_noise([0.05, 0.05, 0.02])


def _vals(a):
    return values_from_numpy({"se2": a}, device="cpu", dtype=F64)


def _stream():
    rng = np.random.default_rng(0)
    n = 10
    truth = np.zeros((n, 3))
    for i in range(1, n):
        truth[i] = np.asarray(jse2.compose(jnp.asarray(truth[i - 1]),
                                           jnp.asarray([1.0, 0.0, 0.1])))
    meas = [None] + [np.asarray(jse2.between(jnp.asarray(truth[i - 1]),
                                             jnp.asarray(truth[i])))
                     + rng.normal(scale=0.01, size=3) for i in range(1, n)]
    return truth, meas


def _add(mod, b, i, m):
    if m is None:
        mod.add_prior(b, "se2", 0, np.zeros(3), PRIOR)
    else:
        mod.add_between(b, "se2", i - 1, i, m, ODO)


def _jax_graph(meas, keep=lambda i: True):
    b = JBuilder()
    for i, m in enumerate(meas):
        if keep(i):
            _add(JF, b, i, m)
    return b.build()


def test_concurrent_matches_batch():
    """test_concurrent.py's stream: the smoother equal to the JAX package's
    batch optimum to 1e-5; synchronize()'s summary equal to the JAX
    package's `_smoother_summary` (to 1e-9); after it the filter's live
    window within 1e-4 of the batch."""
    truth, meas = _stream()
    cfs = concurrent.ConcurrentFilterSmoother(
        filter_lag=4.0, smoother_every=5,
        filter_params=opt.Params(max_iterations=5))
    for i, m in enumerate(meas):
        step = GraphBuilder()
        _add(F, step, i, m)
        cfs.update(step.build(device="cpu", dtype=F64).batches,
                   _vals(truth[: i + 1]), {("se2", i): float(i)})
    cfs.run_smoother()
    jbatch = jopt.optimize_lm(_jax_graph(meas),
                              JValues({"se2": jnp.asarray(truth)}))
    want = np.asarray(jbatch.values["se2"])
    np.testing.assert_allclose(cfs.smoothed_estimate()["se2"].numpy(), want,
                               atol=1e-5)

    # the summary synchronize() builds, against the JAX package's
    boundary = []
    kept_between = set()
    for b in cfs.filter.batches:
        for row in b.idx.numpy():
            if b.name.startswith("marginal_"):
                boundary += [("se2", int(k)) for k in row
                             if ("se2", int(k)) not in boundary]
            elif b.name == "between_se2":
                kept_between.add(int(row[1]))
    assert boundary, "the window never marginalized"
    sm = cfs.smoother_result.values
    kept = FactorGraph([b for b in cfs.filter.batches
                        if not b.name.startswith("marginal_")])
    summary = concurrent._smoother_summary(FactorGraph(cfs.all_batches), sm,
                                           boundary, exclude=kept)
    jsummary = jcon._smoother_summary(
        _jax_graph(meas), JValues({"se2": jnp.asarray(sm["se2"].numpy())}),
        boundary, exclude=_jax_graph(meas, lambda i: i in kept_between))
    for key in summary.meas:
        np.testing.assert_allclose(summary.meas[key].numpy(),
                                   np.asarray(jsummary.meas[key]), rtol=0,
                                   atol=1e-9, err_msg=key)

    cfs.synchronize()
    cfs.filter.update([], None, None)
    live = sorted(i for (g, i) in cfs.filter.timestamps)
    filt = cfs.filter.estimate()["se2"].numpy()[live]
    np.testing.assert_allclose(filt, want[live], atol=1e-4)
    assert cfs.filtered_estimate() is cfs.filter.values
    out = cfs.smoother_summary_on(boundary, exclude=kept)
    np.testing.assert_allclose(out.meas["sqrt_info"].numpy(),
                               summary.meas["sqrt_info"].numpy(), atol=1e-12)


def test_smoother_summary_is_marginal_information():
    """The exchanged factor's information is the inverse of the smoother
    posterior's joint marginal covariance on the boundary, and equals the
    JAX package's summary."""
    b, jb = GraphBuilder(), JBuilder()
    for mod, bb in ((F, b), (JF, jb)):
        mod.add_prior(bb, "se2", 0, np.zeros(3), PRIOR)
        for i in range(3):
            mod.add_between(bb, "se2", i, i + 1, np.array([1.0, 0.0, 0.0]),
                            ODO)
    start = np.cumsum(np.tile([1.0, 0, 0], (4, 1)), axis=0) - [1, 0, 0]
    graph = b.build(device="cpu", dtype=F64)
    vals = opt.optimize_lm(graph, _vals(start)).values
    jgraph = jb.build()
    jvals = jopt.optimize_lm(jgraph, JValues({"se2": jnp.asarray(
        start)})).values
    np.testing.assert_allclose(vals["se2"].numpy(), np.asarray(jvals["se2"]),
                               atol=1e-9)
    boundary = [("se2", 2), ("se2", 3)]
    summary = concurrent._smoother_summary(graph, vals, boundary)
    S = summary.meas["sqrt_info"][0].numpy()
    cov = Marginals(graph, vals, damping=1e-9).joint_marginal_covariance(
        boundary).numpy()
    np.testing.assert_allclose(S.T @ S, np.linalg.inv(cov), rtol=1e-5,
                               atol=1e-6)
    jsummary = jcon._smoother_summary(jgraph, jvals, boundary)
    jS = np.asarray(jsummary.meas["sqrt_info"][0])
    np.testing.assert_allclose(S.T @ S, jS.T @ jS, rtol=1e-9, atol=1e-9)
