"""The port's IncrementalSmoother (nonlinear/incremental.py) against the
JAX package's, in float64 on the CPU.

tests/test_incremental_runner.py streams the first 300 poses of
city10000.g2o, which is not in the repository; the same run here streams a
300-pose `make_manhattan` world (odometry and loop closures, in the
graph's order) through both packages' smoothers with the runner's
settings, and holds the port to the runner's rule (at most 1.3 times the
batch optimum of the same factors) and to the JAX smoother's estimate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.geometry import se2 as jse2
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.nonlinear.incremental import (
    IncrementalSmoother as JSmoother)
from gtsam_personal_tpu.slam import manhattan as jmanhattan
from gtsam_personal_tpu_torch.geometry import se2
from gtsam_personal_tpu_torch.nonlinear.incremental import IncrementalSmoother

N = 300


def _stream(smoother, compose, ij, meas, S):
    smoother.set_prior(np.zeros(3), [0.3, 0.3, 0.1])
    added = 1
    for k in range(len(ij)):
        i, j = int(ij[k, 0]), int(ij[k, 1])
        if j == added:          # an odometry edge: a new pose
            smoother.add_pose(compose(smoother._poses[i], meas[k]))
            added += 1
        smoother.add_between(i, j, meas[k], S[k])
    smoother.solve(iters=6)
    return smoother.solve(iters=8)


@pytest.fixture(scope="module")
def runs():
    jgraph, jinit, _ = jmanhattan.make_manhattan(N, seed=5)
    between = [b for b in jgraph.batches if b.name == "between_se2"][0]
    ij = np.asarray(between.idx)
    meas = np.asarray(between.meas["measured"])
    S = np.asarray(between.noise.data)
    if S.ndim == 2:                             # diagonal sqrt information
        S = np.stack([np.diag(s) for s in S])
    inc = IncrementalSmoother(group="se2", relinearize_every=25,
                              iters_per_update=3, device="cpu")
    err = _stream(inc, lambda a, b: se2.compose(torch.tensor(a),
                                                torch.tensor(b)).numpy(),
                  ij, meas, S)
    jinc = JSmoother(group="se2", relinearize_every=25, iters_per_update=3)
    jerr = _stream(jinc, lambda a, b: np.asarray(jse2.compose(
        jnp.asarray(a), jnp.asarray(b))), ij, meas, S)
    # the runner's batch reference on the same factors
    from gtsam_personal_tpu.core.graph import GraphBuilder
    from gtsam_personal_tpu.core.values import Values
    from gtsam_personal_tpu.slam import factors as JF
    b = GraphBuilder()
    JF.add_prior(b, "se2", 0, np.zeros(3), JF.diag_noise([0.3, 0.3, 0.1]))
    for k in range(len(ij)):
        b.add("between_se2", JF.make_between_residual("se2"), ("se2", "se2"),
              3, list(ij[k]), {"measured": meas[k]},
              {"kind": "full", "data": S[k]})
    bres = jopt.optimize_lm(b.build(), Values({"se2": jnp.asarray(
        np.asarray(jinit["se2"]))}))
    return inc, err, jinc, jerr, bres


def test_incremental_matches_jax_smoother(runs):
    """The same stream through both smoothers: the final error to 1e-9
    relative and the estimate to 1e-6, with the same capacities."""
    inc, err, jinc, jerr, _ = runs
    np.testing.assert_allclose(err, jerr, rtol=1e-9)
    assert (inc.n, inc.f, inc.cap_n, inc.cap_f) == (jinc.n, jinc.f,
                                                    jinc.cap_n, jinc.cap_f)
    np.testing.assert_allclose(inc.estimate(), jinc.estimate(), rtol=0,
                               atol=1e-6)


def test_incremental_runner_rule(runs):
    """test_incremental_runner.py's rule on the stand-in: the streamed
    error at most 1.3 times the batch optimum (or within 1e-3 of it), and
    every position within 3 m of the batch's."""
    inc, err, _, _, bres = runs
    assert err < max(1.3 * bres.error, bres.error + 1e-3), (err, bres.error)
    ref = np.asarray(bres.values["se2"])[:N]
    gap = np.linalg.norm(inc.estimate()[:, :2] - ref[:, :2], axis=1)
    assert gap.max() < 3.0


def test_capacity_doubling():
    """The capacities double as the stream grows, and inactive slots hold
    the identity with zero weight, as in the JAX smoother."""
    inc = IncrementalSmoother(group="se2", relinearize_every=1000,
                              device="cpu")
    jinc = JSmoother(group="se2", relinearize_every=1000)
    for sm in (inc, jinc):
        sm.set_prior(np.zeros(3), [0.3, 0.3, 0.1])
        for k in range(70):
            sm.add_pose(np.array([k + 1.0, 0.0, 0.0]))
            sm.add_between(k, k + 1, np.array([1.0, 0.0, 0.0]), np.eye(3))
    assert (inc.cap_n, inc.cap_f) == (jinc.cap_n, jinc.cap_f) == (128, 128)
    np.testing.assert_array_equal(inc._poses, jinc._poses)
    np.testing.assert_array_equal(inc._sqrt, jinc._sqrt)
    np.testing.assert_allclose(inc.solve(), jinc.solve(), rtol=1e-12,
                               atol=1e-20)
