"""The port's optimize_lm_jit against the JAX package's one-program LM, in
float64 on the CPU, at each of the loop's endings: no try accepted, the
convergence test (here by error_tol) and max_iterations.

One Params and one graph structure serve all three endings, so the JAX
program compiles once: the endings come from the graph's measurements and
the start, which the program takes as data. Tolerances: the iteration
count equal, the error and the values to 1e-9 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.slam import manhattan as jmanhattan
from gtsam_personal_tpu_torch.nonlinear import optimizers as opt
from test_torch_graph import port_graph, port_values

N = 120            # loop closures from pose 51 on: a non-zero optimum
PARAMS = dict(max_iterations=5, relative_error_tol=0.0,
              absolute_error_tol=0.0, error_tol=1e-3, max_inner_tries=2,
              lambda_initial=1e-6)


def _with_meas(jgraph, meas):
    """The graph with the between batch's measurements replaced."""
    batches = []
    for b in jgraph.batches:
        if b.name == "between_se2":
            b = type(b)(b.name, b.residual_fn, b.groups, b.rdim, b.idx,
                        {"measured": jnp.asarray(meas)}, b.noise)
        batches.append(b)
    return type(jgraph)(batches)


def _exact_meas(jgraph, truth):
    (b,) = [b for b in jgraph.batches if b.name == "between_se2"]
    idx = np.asarray(b.idx)
    a, c = truth[idx[:, 0]], truth[idx[:, 1]]
    d = c[:, :2] - a[:, :2]
    ca, sa = np.cos(a[:, 2]), np.sin(a[:, 2])
    th = np.arctan2(np.sin(c[:, 2] - a[:, 2]), np.cos(c[:, 2] - a[:, 2]))
    return np.stack([ca * d[:, 0] + sa * d[:, 1],
                     -sa * d[:, 0] + ca * d[:, 1], th], 1)


@pytest.fixture(scope="module")
def cases():
    jgraph, jvalues, truth = jmanhattan.make_manhattan(N, seed=3)
    rng = np.random.default_rng(1)
    bad = truth + np.concatenate([rng.normal(0, 3.0, (N, 2)),
                                  rng.uniform(-np.pi, np.pi, (N, 1))], 1)
    near = truth + rng.normal(0, 0.02, truth.shape)
    return {
        # odometry-composed start: every iteration accepted, error above
        # error_tol after max_iterations
        "max_iterations": (jgraph, jvalues),
        # noise-free measurements from near the truth: error_tol reached
        "error_tol": (_with_meas(jgraph, _exact_meas(jgraph, truth)),
                      JValues({"se2": jnp.asarray(near)})),
        # random headings: both tries of the first iteration rejected
        "rejected": (jgraph, JValues({"se2": jnp.asarray(bad)})),
    }


@pytest.mark.parametrize("ending,want_it", [("max_iterations", 5),
                                            ("error_tol", None),
                                            ("rejected", 1)])
def test_endings_match_jax(cases, ending, want_it):
    jgraph, jvalues = cases[ending]
    jv, je, jit = jopt.optimize_lm_jit(jgraph, jvalues,
                                       jopt.Params(**PARAMS))
    v, e, it = opt.optimize_lm_jit(port_graph(jgraph), port_values(jvalues),
                                   opt.Params(**PARAMS))
    assert it == int(jit)
    if want_it is not None:
        assert it == want_it
    je = float(je)
    assert abs(float(e) - je) <= 1e-9 * je + 1e-12   # error_tol's is ~0
    if ending == "error_tol":
        assert float(e) <= PARAMS["error_tol"] and it < 5
    if ending == "rejected":
        np.testing.assert_array_equal(v["se2"].numpy(),
                                      np.asarray(jvalues["se2"]))
    got, want = v["se2"].numpy(), np.asarray(jv["se2"])
    assert np.abs(got - want).max() <= 1e-9 * np.abs(want).max()


def test_max_iterations_argument_overrides_params(cases):
    jgraph, jvalues = cases["max_iterations"]
    _, _, it = opt.optimize_lm_jit(port_graph(jgraph), port_values(jvalues),
                                   opt.Params(**PARAMS), max_iterations=2)
    assert it == 2
