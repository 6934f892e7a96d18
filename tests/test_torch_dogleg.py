"""The port's dogleg and nonlinear conjugate gradient optimizers
(nonlinear/dogleg.py) against the JAX package, in float64 on the CPU, on
tests/test_shonan_gnc.py's problem (the reference's 5-pose Pose2 SLAM
example, tests/test_pose2slam.py:build_example)."""

import numpy as np
import pytest

from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.nonlinear.dogleg import (optimize_dogleg as
                                                 j_dogleg,
                                                 optimize_ncg as j_ncg)
from gtsam_personal_tpu_torch.nonlinear import optimizers as opt
from gtsam_personal_tpu_torch.nonlinear.dogleg import (optimize_dogleg,
                                                       optimize_ncg)
from test_pose2slam import build_example
from test_torch_graph import port_graph, port_values


@pytest.fixture(scope="module")
def pose2_example():
    jgraph, jinitial, expected = build_example()
    return jgraph, jinitial, port_graph(jgraph), port_values(jinitial)


def test_dogleg_matches(pose2_example):
    jgraph, jinit, graph, init = pose2_example
    res = optimize_dogleg(graph, init)
    jres = j_dogleg(jgraph, jinit)
    # at the optimum a step changes the error by rounding alone (~1e-20),
    # so whether the last try is taken, and the iteration count with it,
    # is rounding: the two packages agree on the point
    assert res.error < 1e-8 and jres.error < 1e-8
    np.testing.assert_allclose(res.values["se2"].numpy(),
                               np.asarray(jres.values["se2"]), atol=1e-9)


def test_ncg_matches(pose2_example):
    jgraph, jinit, graph, init = pose2_example
    params = opt.Params(max_iterations=200, relative_error_tol=1e-8)
    res = optimize_ncg(graph, init, params)
    jres = j_ncg(jgraph, jinit, jopt.Params(max_iterations=200,
                                            relative_error_tol=1e-8))
    assert res.error < float(opt.graph_error(graph, init)) * 1e-3
    assert res.iterations == jres.iterations
    np.testing.assert_allclose(res.error, jres.error, rtol=1e-6)
    np.testing.assert_allclose(res.values["se2"].numpy(),
                               np.asarray(jres.values["se2"]), atol=1e-6)
