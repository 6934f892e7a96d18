"""The port's fixed-lag smoother (nonlinear/fixed_lag.py) and its tool
(tools/fixed_lag_smoother.py) in float64 on the CPU, on
tests/test_incremental.py's stream and the example's.

The JAX package's FixedLagSmoother compiles a new program at every update
of a stream (the graph's structure grows), seconds an update on a CPU, so
the streams are held to the JAX tests' own rule against the JAX package's
batch optimum of the same factors, and each marginalization to the JAX
package's `marginalize` of the same graph at the same point."""

import jax.numpy as jnp
import numpy as np
import torch

from gtsam_personal_tpu.core.graph import GraphBuilder as JBuilder
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.geometry import se2 as jse2
from gtsam_personal_tpu.linear import marginal as jmarginal
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.slam import factors as JF
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.linear.marginal import marginalize
from gtsam_personal_tpu_torch.nonlinear import fixed_lag, optimizers as opt
from gtsam_personal_tpu_torch.slam import factors as F
from gtsam_personal_tpu_torch.tools import fixed_lag_smoother

F64 = torch.float64


def _vals(a):
    return values_from_numpy({"se2": a}, device="cpu", dtype=F64)


def _stream():
    """test_incremental.py's stream: 10 poses, lag 4, a prior, odometry
    with 0.01 noise; per step the measurement (None for the prior)."""
    rng = np.random.default_rng(3)
    n = 10
    poses = np.zeros((n, 3))
    for i in range(1, n):
        poses[i] = np.asarray(jse2.compose(jnp.asarray(poses[i - 1]),
                                           jnp.asarray([1.0, 0.0, 0.05])))
    meas = [None]
    for i in range(1, n):
        meas.append(np.asarray(jse2.between(jnp.asarray(poses[i - 1]),
                                            jnp.asarray(poses[i])))
                    + rng.normal(scale=0.01, size=3))
    return poses, meas


def _add(mod, b, i, m):
    if m is None:
        mod.add_prior(b, "se2", 0, np.zeros(3), F.diag_noise([0.1, 0.1,
                                                              0.05]))
    else:
        mod.add_between(b, "se2", i - 1, i, m, F.diag_noise([0.05, 0.05,
                                                             0.02]))


def test_fixed_lag_tracks_jax_batch():
    """The port's smoother on the stream: the newest three poses within
    1e-3 of the JAX package's batch optimum (the JAX test's rule), the
    first marginalization's factor equal to the JAX package's marginalize
    of the same graph and point (to 1e-9), and the frozen poses kept."""
    poses, meas = _stream()
    sm = fixed_lag.FixedLagSmoother(lag=4.0,
                                    params=opt.Params(max_iterations=8))
    jall = JBuilder()
    first = None
    for i, m in enumerate(meas):
        b = GraphBuilder()
        _add(F, b, i, m)
        _add(JF, jall, i, m)
        sm.update(b.build(device="cpu", dtype=F64).batches,
                  _vals(poses[: i + 1]), {("se2", i): float(i)})
        if first is None and any(x.name.startswith("marginal_")
                                 for x in sm.batches):
            first = i
    jres = jopt.optimize_lm(jall.build(), JValues({"se2": jnp.asarray(
        poses)}))
    got = sm.estimate()["se2"].numpy()
    want = np.asarray(jres.values["se2"])
    np.testing.assert_allclose(got[-3:], want[-3:], atol=1e-3)
    assert set(sm.frozen["se2"]) == {0, 1, 2, 3, 4}
    for k, p in sm.frozen["se2"].items():
        np.testing.assert_array_equal(p, got[k])

    # the first marginalization (of pose 0, at update `i`), again by hand
    # in both packages at the point the smoother marginalized at
    i = first
    jb, pb = JBuilder(), GraphBuilder()
    for k in range(i + 1):
        _add(JF, jb, k, meas[k])
        _add(F, pb, k, meas[k])
    graph = pb.build(device="cpu", dtype=F64)
    point = opt.optimize_lm(graph, _vals(poses[: i + 1]),
                            opt.Params(max_iterations=8)).values
    _, marg, bound = marginalize(graph, point, {"se2": [0]})
    _, jmarg, jbound = jmarginal.marginalize(
        jb.build(), JValues({"se2": jnp.asarray(point["se2"].numpy())}),
        {"se2": [0]})
    assert bound == jbound == [("se2", 1)]
    for key in ("sqrt_info", "r0", "anchor0"):
        np.testing.assert_allclose(marg.meas[key].numpy(),
                                   np.asarray(jmarg.meas[key]), rtol=0,
                                   atol=1e-9)


def test_fixed_lag_smoother_tool():
    """The tool (the example's 30 steps, lag 2 s, dt 0.25 s): FIXED-LAG
    OK, its batch equal to the JAX package's batch of the same
    measurements (the example's draws) to 1e-9, its newest estimates
    within the example's 1e-2 of that batch."""
    lines = []
    rec = fixed_lag_smoother.run(device="cpu", say=lines.append)
    assert rec["ok"] and lines[-1] == "FIXED-LAG OK"
    dt, n = 0.25, 30
    step = np.array([2.0 * dt, 0.0, 0.1 * dt])
    rng = np.random.default_rng(0)
    truth = np.zeros((n, 3))
    for i in range(1, n):
        truth[i] = np.asarray(jse2.compose(jnp.asarray(truth[i - 1]),
                                           jnp.asarray(step)))
    jb = JBuilder()
    JF.add_prior(jb, "se2", 0, truth[0], F.diag_noise([0.1, 0.1, 0.05]))
    for i in range(1, n):
        m = step + rng.normal(scale=[0.02, 0.02, 0.01])
        JF.add_between(jb, "se2", i - 1, i, m, F.diag_noise([0.05, 0.05,
                                                             0.02]))
    jres = jopt.optimize_lm(jb.build(dtype=np.float64),
                            JValues({"se2": jnp.asarray(truth)}),
                            jopt.Params(max_iterations=20))
    want = np.asarray(jres.values["se2"])
    np.testing.assert_allclose(rec["batch"], want, rtol=0, atol=1e-9)
    assert np.abs(rec["estimate"][-3:] - want[-3:]).max() < 1e-2


def test_merge_values():
    a = _vals(np.zeros((2, 3)))
    b = _vals(np.ones((4, 3)))
    m = fixed_lag._merge_values(a, b)["se2"].numpy()
    np.testing.assert_array_equal(m, np.r_[np.zeros((2, 3)),
                                           np.ones((2, 3))])
    assert fixed_lag._merge_values(None, b) is b
