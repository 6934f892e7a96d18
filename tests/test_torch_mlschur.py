"""The port's multi-level Schur elimination (linear/mlschur.py) against the
JAX package's, in float64 on the CPU: the four cases of
tests/test_mlschur.py on seeded stand-ins for its data files (a 300-pose
Manhattan world for w100.graph, an 8-pose SE(3) chain for
pose3example.txt). For each plan: its tables entry for entry, `solve_ml`
against the JAX `solve_ml` (1e-10) and the port's dense solve at
lambda = 0 and 1e-3, and `optimize_lm(solver="schur", plan=mlplan)` against
the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core import graph as jgraph_mod, values as jvalues_mod
from gtsam_personal_tpu.linear import fm as jfm, linearize as jlin
from gtsam_personal_tpu.linear import mlschur as jml
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.slam import factors as JF, manhattan as jmanhattan
from gtsam_personal_tpu_torch.core.values import Layout
from gtsam_personal_tpu_torch.linear import mlschur, solvers
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.nonlinear import optimizers as opt
from test_torch_graph import _se3_chain, port_graph, port_values

N_POSES = 300
# (graph, max_part_size, root_max_dim, max_levels) -> levels
CASES = {"four_levels": ("se2", 12, 24, 5),
         "one_level": ("se2", 32, 64, 4),
         "all_root": ("se2", 64, 10 ** 6, 4),
         "se3": ("se3", 2, 6, 3)}
LEVELS = {"four_levels": 4, "one_level": 1, "all_root": 0}


class Graphs:
    def __init__(self):
        jg, jv, _ = jmanhattan.make_manhattan(N_POSES, seed=3)
        jb = jgraph_mod.GraphBuilder()
        init = _se3_chain([jb], [JF], n=8)
        self.j = {"se2": (jg, jv),
                  "se3": (jb.build(dtype=np.float64),
                          jvalues_mod.Values({"se3": jnp.asarray(init)}))}
        self.port = {k: (port_graph(g), port_values(v))
                     for k, (g, v) in self.j.items()}
        self.jlin = {k: jax.jit(jlin.linearize)(*gv)
                     for k, gv in self.j.items()}
        self.lin = {k: linearize(*gv) for k, gv in self.port.items()}
        self.plans = {}

    def plans_of(self, name):
        if name not in self.plans:
            key, *args = CASES[name]
            counts = self.port[key][1].counts()
            self.plans[name] = (mlschur.make_ml_plan(self.port[key][0],
                                                     counts, *args),
                                jml.make_ml_plan(self.j[key][0], counts,
                                                 *args))
        return self.plans[name]


@pytest.fixture(scope="module")
def graphs():
    return Graphs()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_targets(tgt, jtgt, size):
    """Port targets == JAX targets where the JAX target is in its buffer;
    the JAX targets past the end (dropped there) are the pad slot here."""
    t, j = _np(tgt), _np(jtgt).astype(np.int64)
    live = j < size
    np.testing.assert_array_equal(t[live], j[live])
    assert (t[~live] == size - 1).all()
    return int((~live).sum())


def check_tables(plan, jplan):
    """Every table of the two plans, entry for entry; returns how many
    JAX targets lie past the end of their buffer."""
    assert plan.stats() == jplan.stats()
    assert (plan.R_dim, plan.Rfw, plan.sol_total, plan.sol_base,
            plan.sol_root_base) == (jplan.R_dim, jplan.Rfw, jplan.sol_total,
                                    jplan.sol_base, jplan.sol_root_base)
    for per, jper in zip(plan.batch_asm, jplan.batch_asm):
        assert list(per) == list(jper)
        for lv in per:
            np.testing.assert_array_equal(_np(per[lv]["sel"]),
                                          _np(jper[lv]["sel"]))
            np.testing.assert_array_equal(per[lv]["col"], jper[lv]["col"])
            if lv != mlschur.ROOT:
                np.testing.assert_array_equal(per[lv]["part"],
                                              _np(jper[lv]["part"]))
    sizes = plan.buffer_sizes()
    past = 0
    for lv in plan.asm_tgt:
        for which, size in zip(("blk", "rhs"), sizes[lv]):
            past += _same_targets(plan.asm_tgt[lv][which],
                                  jplan.asm_tgt[lv][which], size)
    for buckets, jbuckets in zip(plan.ea, jplan.ea):
        assert len(buckets) == len(jbuckets)
        for b, jb in zip(buckets, jbuckets):
            assert b["sdb"] == jb["sdb"] and list(b["dst"]) == list(jb["dst"])
            np.testing.assert_array_equal(_np(b["ids"]), _np(jb["ids"]))
            for dl in b["dst"]:
                blk, rhs = sizes[mlschur.ROOT if dl == -1 else dl]
                past += _same_targets(b["dst"][dl]["tgt"],
                                      jb["dst"][dl]["tgt"], blk)
                past += _same_targets(b["dst"][dl]["tgt_rhs"],
                                      jb["dst"][dl]["tgt_rhs"], rhs)
    for m, jm in zip(plan.l2sol, jplan.l2sol):
        np.testing.assert_array_equal(_np(m), _np(jm))
    for g in jplan.delta_gather:
        np.testing.assert_array_equal(_np(plan.delta_gather[g]),
                                      _np(jplan.delta_gather[g]))
    return past


@pytest.mark.parametrize("name", list(CASES))
def test_plan_tables_match(graphs, name):
    plan, jplan = graphs.plans_of(name)
    if name in LEVELS:
        assert plan.L == LEVELS[name]
    check_tables(plan, jplan)


@pytest.mark.parametrize("name", list(CASES))
def test_solve_ml_matches(graphs, name):
    """solve_ml == the JAX solve_ml (1e-10) and == the dense solve (the
    tolerances of tests/test_mlschur.py), at lambda 0 and 1e-3."""
    key = CASES[name][0]
    plan, jplan = graphs.plans_of(name)
    lin, jl = graphs.lin[key], graphs.jlin[key]
    layout = Layout.of(graphs.port[key][1])
    jsolve = jax.jit(lambda lin_, lam: jml.solve_ml(lin_, jplan, lam))
    rtol, atol = (1e-6, 1e-8) if key == "se3" else (1e-7, 1e-9)
    for lam in (0.0, 1e-3):
        d = solvers.solve_dense(lin, layout, lam)
        d_ml = mlschur.solve_ml(lin, plan, lam)
        jd = jsolve(jl, lam)
        for g in d:
            np.testing.assert_allclose(d_ml[g].numpy(), np.asarray(jd[g]),
                                       rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(d_ml[g].numpy(), d[g].numpy(),
                                       rtol=rtol, atol=atol)


def test_solve_ml_fm_input_runs_the_row_layout(graphs):
    """tests/test_mlschur.py:test_ml_fm_matches: the JAX solve_ml on its
    feature-major linearization against the port's on the row layout."""
    jg, jv = graphs.j["se2"]
    g, v = graphs.port["se2"]
    counts = v.counts()
    plan = mlschur.make_ml_plan(g, counts, 16, 30, 4)
    jplan = jml.make_ml_plan(jg, counts, 16, 30, 4)
    jd = jax.jit(lambda lin_: jml.solve_ml(lin_, jplan, 1e-4))(
        jax.jit(jfm.linearize_fm)(jg, jv))
    d = mlschur.solve_ml(graphs.lin["se2"], plan, 1e-4)
    np.testing.assert_allclose(d["se2"].numpy(), np.asarray(jd["se2"]),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", list(CASES))
def test_optimize_lm_with_ml_plan_matches(graphs, name):
    key = CASES[name][0]
    plan, jplan = graphs.plans_of(name)
    ref = jopt.optimize_lm(*graphs.j[key],
                           jopt.Params(solver="schur",
                                       diagnose_on_failure=False),
                           plan=jplan)
    res = opt.optimize_lm(*graphs.port[key], opt.Params(solver="schur"),
                          plan)
    assert (res.iterations, res.converged) == (ref.iterations, ref.converged)
    assert res.error == pytest.approx(ref.error, rel=1e-9)
    np.testing.assert_allclose(res.values[key].numpy(),
                               np.asarray(ref.values[key]), rtol=0,
                               atol=1e-8)


def test_lm_run_with_ml_plan_equals_two_level(graphs):
    """lm_run with an MLPlan ends where it ends with the two-level plan."""
    from gtsam_personal_tpu_torch.linear import schur
    g, v = graphs.port["se2"]
    plan, _ = graphs.plans_of("four_levels")
    e0 = opt.graph_error(g, v)
    out = [opt.lm_run(g, v, 1e-5, e0, 4, opt.Params(solver="schur"), p)
           for p in (plan, schur.make_plan(g, v.counts(), 32))]
    torch.testing.assert_close(out[0][2], out[1][2], rtol=1e-12, atol=0.0)
    torch.testing.assert_close(out[0][0]["se2"], out[1][0]["se2"],
                               rtol=0.0, atol=1e-10)


def test_every_target_inside_its_buffer(graphs):
    """The guard of the dead scatter targets. The JAX plan points them past
    the end of the right-hand-side buffers (its scatters drop them);
    `index_add_` would raise here (IndexError on the CPU) or write out of
    bounds on a card. The four-level plan has such targets; in the port
    every target lies inside its buffer and the solve runs."""
    plan, jplan = graphs.plans_of("four_levels")
    assert check_tables(plan, jplan) > 0       # the JAX plan has them
    n_tables = 0
    for name, tgt, size in plan.scatter_targets():
        t = _np(tgt)
        assert t.size == 0 or (t.min() >= 0 and t.max() < size), name
        n_tables += 1
    assert n_tables > 4 * plan.L
    d = mlschur.solve_ml(graphs.lin["se2"], plan, 1e-3)
    d_ref = solvers.solve_dense(graphs.lin["se2"],
                                Layout.of(graphs.port["se2"][1]), 1e-3)
    np.testing.assert_allclose(d["se2"].numpy(), d_ref["se2"].numpy(),
                               rtol=1e-7, atol=1e-9)


def test_indefinite_front_gives_nan_not_an_exception(graphs):
    """A front that is not positive definite gives a NaN step (the JAX
    Cholesky's contract), which LM rejects, instead of raising."""
    g, v = graphs.port["se2"]
    plan, _ = graphs.plans_of("four_levels")
    lin = graphs.lin["se2"]
    d = mlschur.solve_ml(lin, plan, -1e6)
    assert torch.isnan(d["se2"]).any()
