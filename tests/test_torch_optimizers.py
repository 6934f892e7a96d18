"""The port's optimizers (lm_run, optimize_lm, optimize_gn), the
Manhattan-world generator and the ATE metric against the JAX package, in
float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.linear import schur as jschur
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.slam import manhattan as jmanhattan, metrics as jmetrics
from gtsam_personal_tpu_torch.core import graph as graph_mod
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear import schur
from gtsam_personal_tpu_torch.nonlinear import optimizers as opt
from gtsam_personal_tpu_torch.slam import (factors as F, manhattan, metrics)
from test_torch_graph import port_graph, port_values

F64 = torch.float64
N_POSES, MAX_PART = 200, 32


class Case:
    def __init__(self):
        self.jgraph, self.jvalues, self.truth = jmanhattan.make_manhattan(
            N_POSES, seed=3)
        self.graph = port_graph(self.jgraph)
        self.values = port_values(self.jvalues)
        counts = {"se2": N_POSES}
        self.jplan = jschur.make_plan(self.jgraph, counts, MAX_PART)
        self.plan = schur.make_plan(self.graph, counts, MAX_PART)


@pytest.fixture(scope="module")
def case():
    return Case()


# --- the generator and the metric -------------------------------------------

def test_make_manhattan_matches(case):
    """Index arrays exactly; measurements, noise and initial values to atol
    1e-12 (cos and sin of libm against XLA's may differ in the last bit)."""
    g, v, truth = manhattan.make_manhattan(N_POSES, seed=3, device="cpu",
                                           dtype=F64)
    np.testing.assert_array_equal(truth, case.truth)
    assert [b.name for b in g.batches] == [b.name for b in
                                           case.jgraph.batches]
    for b, jb in zip(g.batches, case.jgraph.batches):
        np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
        for k in b.meas:
            np.testing.assert_allclose(b.meas[k].numpy(),
                                       np.asarray(jb.meas[k]), rtol=0,
                                       atol=1e-12)
        np.testing.assert_array_equal(b.noise.data.numpy(),
                                      np.asarray(jb.noise.data))
    assert g.num_factors > N_POSES          # there are loop closures
    np.testing.assert_allclose(v["se2"].numpy(),
                               np.asarray(case.jvalues["se2"]), rtol=0,
                               atol=1e-12)


def test_make_manhattan_options_match():
    kw = dict(seed=7, turn_prob=0.4, closure_radius=2.5,
              max_closures_per_pose=2, trans_sigma=0.1, rot_sigma=0.02,
              init_from_odometry=False)
    g, v, truth = manhattan.make_manhattan(120, device="cpu", dtype=F64, **kw)
    jg, jv, jtruth = jmanhattan.make_manhattan(120, **kw)
    np.testing.assert_array_equal(truth, jtruth)
    for b, jb in zip(g.batches, jg.batches):
        np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
        np.testing.assert_allclose(
            b.meas[next(iter(b.meas))].numpy(),
            np.asarray(jb.meas[next(iter(jb.meas))]), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(v["se2"].numpy(), np.asarray(jv["se2"]))


@pytest.mark.parametrize("align,with_scale", [(True, False), (True, True),
                                              (False, False)])
def test_ate_matches(case, align, with_scale):
    est = np.asarray(case.jvalues["se2"])[:, :2]
    got = metrics.ate(est, case.truth[:, :2], align, with_scale)
    assert got == jmetrics.ate(est, case.truth[:, :2], align, with_scale)
    assert got["rmse"] > 0


# --- lm_run ------------------------------------------------------------------

# (solver, lambda0, iterations). From lambda0 = 1e2 every one of the 6
# iterations still lowers the error by far more than rounding, so every
# accept/reject decision is determined. From 1e-5 (the bench's start) this
# graph has converged to the last bit after 4 iterations, and a further
# try's `new < old` compares two errors that differ by rounding alone: that
# run stops at 3.
LM_RUNS = [("dense", 1e2, 6), ("schur", 1e2, 6), ("schur", 1e-5, 3)]


@pytest.fixture(scope="module")
def lm_runs(case):
    """lm_run in both packages, for each entry of LM_RUNS."""
    out = {}
    je0 = jopt.graph_error(case.jgraph, case.jvalues)
    e0 = opt.graph_error(case.graph, case.values)
    for solver, lam0, n in LM_RUNS:
        jplan = case.jplan if solver == "schur" else None
        plan = case.plan if solver == "schur" else None
        ref = jopt.lm_run(case.jgraph, case.jvalues, jnp.asarray(lam0), je0,
                          n_iters=n, params=jopt.Params(solver=solver),
                          plan=jplan)
        got = opt.lm_run(case.graph, case.values, lam0, e0, n,
                         opt.Params(solver=solver), plan)
        out[(solver, lam0, n)] = (ref, got)
    return float(je0), float(e0), out


@pytest.mark.parametrize("run", LM_RUNS)
def test_lm_run_error(lm_runs, run):
    je0, e0, out = lm_runs
    (_, _, e_ref), (_, _, e) = out[run]
    assert e0 == pytest.approx(je0, rel=1e-12)
    assert e.dim() == 0 and float(e) < 1e-2 * e0
    assert float(e) == pytest.approx(float(e_ref), rel=1e-9)


@pytest.mark.parametrize("run", LM_RUNS)
def test_lm_run_lambda(lm_runs, run):
    """The port takes the same accept/reject decisions, so lambda is the
    same power of the factor. Held to rel 1e-14, not bitwise: XLA compiles
    `lam / 10.0` into a product with the rounded reciprocal, which is off by
    one unit in the last place per step (1e2 -> 0.00010000000000000003 after
    six accepts), where torch divides and gives 0.0001."""
    (_, lam_ref, _), (_, lam, _) = lm_runs[2][run]
    assert lam.dim() == 0
    assert float(lam) == pytest.approx(float(lam_ref), rel=1e-14)
    assert float(lam) == pytest.approx(run[1] / 10.0 ** run[2], rel=1e-14)


@pytest.mark.parametrize("run", LM_RUNS)
def test_lm_run_values(lm_runs, run):
    (v_ref, _, _), (v, _, _) = lm_runs[2][run]
    np.testing.assert_allclose(v["se2"].numpy(), np.asarray(v_ref["se2"]),
                               rtol=0, atol=1e-8)


def _two_pose_graph_with_a_bad_start():
    """Two poses and one far-off loop, started so far from the optimum that
    the first tries at a tiny lambda overshoot: rejects come before the
    accepts."""
    b = graph_mod.GraphBuilder()
    F.add_prior(b, "se2", 0, np.zeros(3), F.diag_noise([0.01, 0.01, 0.01]))
    F.add_between(b, "se2", 0, 1, np.array([1.0, 0.0, 3.0]),
                  F.diag_noise([0.01, 0.01, 0.01]))
    F.add_between(b, "se2", 1, 2, np.array([1.0, 0.0, 3.0]),
                  F.diag_noise([0.01, 0.01, 0.01]))
    g = b.build(device="cpu", dtype=F64)
    v = Values({"se2": torch.tensor([[0.0, 0.0, 0.0], [5.0, 4.0, -2.0],
                                     [-3.0, 6.0, 1.0]], dtype=F64)})
    return g, v


def test_lm_run_reject_reuses_linearization(monkeypatch):
    """A rejected try leaves values and error as they were, multiplies
    lambda by the factor, and does not linearize again; the result equals
    that of a loop that linearizes before every try."""
    g, v = _two_pose_graph_with_a_bad_start()
    e0 = g.error(v)
    calls = []
    real = opt.linearize
    monkeypatch.setattr(opt, "linearize",
                        lambda *a: calls.append(1) or real(*a))
    n = 8
    v1, lam1, e1 = opt.lm_run(g, v, 1e-9, e0, n)
    n_linearized = len(calls)
    # reference loop: one fresh linearization per try
    vv, lam, err = v, 1e-9, float(e0)
    accepted = []
    for _ in range(n):
        nv, ne, _ = opt._lm_try_step(g, vv, lam, opt.Params())
        accepted.append(bool(np.isfinite(float(ne)) and float(ne) < err))
        if accepted[-1]:
            vv, err, lam = nv, float(ne), max(lam / 10.0, 1e-10)
        else:
            lam = min(lam * 10.0, 1e5)
    assert 0 < sum(accepted) < n, "the case must hold accepts and rejects"
    # once at the start, then once after each accept that a try follows
    assert n_linearized == 1 + sum(accepted[:-1])
    np.testing.assert_array_equal(v1["se2"].numpy(), vv["se2"].numpy())
    assert float(lam1) == pytest.approx(lam, rel=1e-15)
    assert float(e1) == err


def test_lm_run_rejects_a_system_that_is_not_positive_definite(case):
    """With a negative lambda of huge size every Cholesky fails. JAX returns
    NaN and rejects the try; the port must do the same without raising:
    values and error stay, lambda is multiplied by the factor each time."""
    e0 = opt.graph_error(case.graph, case.values)
    for solver, plan in (("dense", None), ("schur", case.plan)):
        v, lam, e = opt.lm_run(case.graph, case.values, -1e9, e0, 3,
                               opt.Params(solver=solver), plan)
        np.testing.assert_array_equal(v["se2"].numpy(),
                                      case.values["se2"].numpy())
        assert float(e) == float(e0)
        assert float(lam) == -1e12
    jv, jlam, je = jopt.lm_run(
        case.jgraph, case.jvalues, jnp.asarray(-1e9),
        jopt.graph_error(case.jgraph, case.jvalues), n_iters=3,
        params=jopt.Params(solver="schur"), plan=case.jplan)
    assert float(jlam) == -1e12 and float(je) == pytest.approx(float(e0))


def test_optimize_lm_grows_lambda_on_indefinite_system(case):
    """optimize_lm at a negative lambda: no exception, the tries are
    rejected until lambda passes its bound, and the result says so."""
    res = opt.optimize_lm(case.graph, case.values,
                          opt.Params(lambda_initial=-1.0,
                                     lambda_upper_bound=-1e3))
    assert not res.converged and res.iterations == 0
    assert res.error == float(opt.graph_error(case.graph, case.values))


# --- host-driven optimizers -------------------------------------------------

@pytest.mark.parametrize("solver", ["dense", "schur", "pcg"])
def test_optimize_lm_matches(case, solver):
    kw = dict(solver=solver, pcg_maxiter=2000, pcg_tol=1e-12)
    jplan = case.jplan if solver == "schur" else None
    plan = case.plan if solver == "schur" else None
    seen = []
    ref = jopt.optimize_lm(case.jgraph, case.jvalues,
                           jopt.Params(diagnose_on_failure=False, **kw),
                           plan=jplan)
    res = opt.optimize_lm(
        case.graph, case.values,
        opt.Params(iteration_hook=lambda *a: seen.append(a), **kw), plan=plan)
    assert (res.iterations, res.converged) == (ref.iterations, ref.converged)
    assert res.converged and len(seen) == res.iterations
    # PCG stops at a residual tolerance, not at the exact solution
    rel = 1e-9 if solver != "pcg" else 1e-7
    assert res.error == pytest.approx(ref.error, rel=rel)
    assert res.lambda_final == pytest.approx(ref.lambda_final, rel=1e-12)
    ate = metrics.ate(res.values["se2"][:, :2].numpy(), case.truth[:, :2])
    assert ate["rmse"] < 0.15


def test_optimize_lm_diagonal_damping_matches(case):
    kw = dict(diagonal_damping=True, lambda_initial=1e-3)
    ref = jopt.optimize_lm(case.jgraph, case.jvalues,
                           jopt.Params(diagnose_on_failure=False, **kw))
    res = opt.optimize_lm(case.graph, case.values, opt.Params(**kw))
    assert (res.iterations, res.converged) == (ref.iterations, ref.converged)
    assert res.error == pytest.approx(ref.error, rel=1e-9)


@pytest.mark.parametrize("solver", ["dense", "schur"])
def test_optimize_gn_matches(case, solver):
    jplan = case.jplan if solver == "schur" else None
    plan = case.plan if solver == "schur" else None
    ref = jopt.optimize_gn(case.jgraph, case.jvalues,
                           jopt.Params(solver=solver,
                                       diagnose_on_failure=False), plan=jplan)
    res = opt.optimize_gn(case.graph, case.values, opt.Params(solver=solver),
                          plan)
    assert (res.iterations, res.converged) == (ref.iterations, ref.converged)
    assert res.error == pytest.approx(ref.error, rel=1e-9)


def test_optimize_lm_fm_matches(case):
    """Params(fm=True, solver="pcg"): the JAX package's feature-major
    layout against the port's row layout, which takes its place."""
    kw = dict(solver="pcg", fm=True, pcg_maxiter=2000, pcg_tol=1e-12)
    ref = jopt.optimize_lm(case.jgraph, case.jvalues,
                           jopt.Params(diagnose_on_failure=False, **kw))
    res = opt.optimize_lm(case.graph, case.values, opt.Params(**kw))
    assert (res.iterations, res.converged) == (ref.iterations, ref.converged)
    assert res.converged
    # PCG stops at a residual tolerance, not at the exact solution
    assert res.error == pytest.approx(ref.error, rel=1e-7)
    assert res.lambda_final == pytest.approx(ref.lambda_final, rel=1e-12)


def test_check_convergence_matches():
    for old, new in ((10.0, 9.0), (10.0, 9.99999), (1e-3, 1e-3 - 1e-7),
                     (5.0, 6.0), (0.0, 0.0)):
        for kw in ({}, {"error_tol": 9.5}, {"relative_error_tol": 0.2}):
            assert opt.check_convergence(opt.Params(**kw), old, new) == \
                jopt.check_convergence(jopt.Params(**kw), old, new)


@pytest.mark.parametrize("kw,exc", [
    ({"solver": "cholmod"}, ValueError),
])
def test_unported_paths_raise(case, kw, exc):
    e0 = opt.graph_error(case.graph, case.values)
    with pytest.raises(exc, match="unknown solver"):
        opt.lm_run(case.graph, case.values, 1e-5, e0, 1, opt.Params(**kw),
                   case.plan)
    with pytest.raises(exc):
        opt.optimize_lm(case.graph, case.values, opt.Params(**kw), case.plan)


@pytest.mark.parametrize("solver", ["qr", "sequential"])
def test_elimination_solvers_match(case, solver):
    """Params(solver="qr" | "sequential") in lm_run and optimize_lm against
    the JAX package's on the same graph."""
    e0 = opt.graph_error(case.graph, case.values)
    v, lam, err = opt.lm_run(case.graph, case.values, 1e-5, e0, 4,
                             opt.Params(solver=solver))
    jv, jlam, jerr = jopt.lm_run(case.jgraph, case.jvalues, 1e-5,
                                 float(e0), 4, jopt.Params(solver=solver))
    assert float(lam) == pytest.approx(float(jlam), rel=1e-12)
    assert float(err) == pytest.approx(float(jerr), rel=1e-9)
    np.testing.assert_allclose(v["se2"].numpy(), np.asarray(jv["se2"]),
                               rtol=0, atol=1e-9)
    ref = jopt.optimize_lm(case.jgraph, case.jvalues,
                           jopt.Params(solver=solver, max_iterations=20,
                                       diagnose_on_failure=False))
    res = opt.optimize_lm(case.graph, case.values,
                          opt.Params(solver=solver, max_iterations=20))
    assert (res.iterations, res.converged) == (ref.iterations, ref.converged)
    assert res.error == pytest.approx(ref.error, rel=1e-9)


def test_schur_needs_a_schur_plan(case):
    e0 = opt.graph_error(case.graph, case.values)
    with pytest.raises(ValueError, match="make_plan"):
        opt.lm_run(case.graph, case.values, 1e-5, e0, 1,
                   opt.Params(solver="schur"))
    with pytest.raises(TypeError, match="SchurPlan or an mlschur.MLPlan"):
        opt.lm_run(case.graph, case.values, 1e-5, e0, 1,
                   opt.Params(solver="schur"), plan=object())
