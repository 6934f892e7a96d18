"""The port's hybrid inference (gtsam_personal_tpu_torch.hybrid) against
the JAX package's, in float64 on the CPU.

Each entry point (solve, solve_beam, HybridSmoother, HybridISAM) is held once
against the JAX package on a small problem built from the same numpy
arrays: mode assignments equal, posteriors and values to 1e-9. The JAX
side compiles a vmapped LM for each hypothesis count, so its problems stay
small. The port's bounded beam and its streams are then held, at the JAX
test file's sizes, to what the JAX tests hold them to: the true modes and
the port's own exact enumeration. ISAM2.clone's branches are independent
bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.graph import FactorBatch as JBatch
from gtsam_personal_tpu.core.graph import FactorGraph as JGraph
from gtsam_personal_tpu.core.graph import GraphBuilder as JBuilder
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.hybrid import hybrid as jh
from gtsam_personal_tpu.linear.noise import NoiseModel as JNoise
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.nonlinear.isam2 import ISAM2Params as JISAM2Params
from gtsam_personal_tpu.slam import factors as JF
from gtsam_personal_tpu_torch.core.graph import FactorBatch
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.hybrid import hybrid as h
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers as opt
from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2, ISAM2Params
from gtsam_personal_tpu_torch.slam import factors as F
from test_torch_graph import jax_graph_to_numpy, port_graph

F64 = torch.float64
CPU = "cpu"


def _se2_compose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     a[2] + b[2]])


def _se2_between(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))])


def _jbatch(kind, i, j, meas, sigma):
    b = JBuilder()
    if kind == "prior":
        JF.add_prior(b, "se2", i, meas, JF.diag_noise([sigma] * 3))
    else:
        JF.add_between(b, "se2", i, j, meas, JF.diag_noise([sigma] * 3))
    return b.build(dtype=jnp.float64).batches[0]


def _jhybrid(kind, i, j, modes, sigma, var):
    """A JAX HybridFactor with measurements [modes, 1, 3]."""
    base = _jbatch(kind, i, j, modes[0], sigma)
    key = next(iter(base.meas))
    return jh.HybridFactor(
        JBatch(base.name, base.residual_fn, base.groups, 3, base.idx,
               {key: jnp.asarray(np.stack(modes))[:, None]}, base.noise),
        mode_var=var, num_modes=len(modes))


def _port_hybrid(jhf):
    """The port's HybridFactor from the same stacked arrays."""
    (d,) = jax_graph_to_numpy(JGraph([jhf.batch]))
    return h.hybrid_factor_from_numpy(d, F.residual_by_name, jhf.mode_var,
                                      jhf.num_modes, device=CPU, dtype=F64)


def _both_graphs(continuous, hybrids, priors=()):
    jg, g = jh.HybridFactorGraph(), h.HybridFactorGraph()
    for b in continuous:
        jg.add_continuous(b)
        g.add_continuous(port_graph(JGraph([b])).batches[0])
    for hf in hybrids:
        jg.add_hybrid(hf)
        g.add_hybrid(_port_hybrid(hf))
    for v, p in priors:
        jg.add_discrete_prior(v, p)
        g.add_discrete_prior(v, p)
    return jg, g


def _values(x):
    return (JValues({"se2": jnp.asarray(x)}),
            Values({"se2": torch.tensor(np.asarray(x), dtype=F64)}))


def _same_result(got, want, tol=1e-9):
    (v, a, post), (jv, ja, jpost) = got, want
    assert a == ja
    assert post.keys() == jpost.keys()
    for k in post:
        assert abs(post[k] - jpost[k]) <= tol
    np.testing.assert_allclose(v["se2"].numpy(), np.asarray(jv["se2"]),
                               rtol=0, atol=tol)


def chain_problem(n, mode_vars, seed=3):
    """JAX TestHybridBeam's chain: odometry, and per mode variable an
    ambiguous unary prior on pose 1 + k % (n-1) (inlier at mode k % 2)."""
    rng = np.random.default_rng(seed)
    truth = np.arange(n)[:, None] * np.array([1.0, 0.0, 0.0])
    cont = [_jbatch("prior", 0, None, truth[0], 1e-3)] + [
        _jbatch("between", i, i + 1, np.array([1.0, 0.0, 0.0]), 0.05)
        for i in range(n - 1)]
    hybrids, true_modes = [], {}
    for k in range(mode_vars):
        i = 1 + (k % (n - 1))
        good = truth[i] + rng.normal(0, 0.02, 3)
        bad = truth[i] + np.array([4.0, 2.0, 1.0])
        modes = [good, bad] if k % 2 == 0 else [bad, good]
        hybrids.append(_jhybrid("prior", i, None, modes, 0.1, 200 + k))
        true_modes[200 + k] = k % 2
    init = truth + rng.normal(0, 0.05, truth.shape)
    return cont, hybrids, init, truth, true_modes


# --- against the JAX package -------------------------------------------------

@pytest.fixture(scope="module")
def chain32():
    """One instance for both tests below: the JAX programs are keyed by
    the batches' residual functions, so the beam's second step reuses the
    enumeration's compile."""
    return chain_problem(3, 2)


def test_solve_matches_jax(chain32):
    """Exact enumeration (4 hypotheses) on a 3-pose chain with two
    ambiguous priors and a discrete prior on one mode."""
    cont, hybrids, init, _, true_modes = chain32
    jg, g = _both_graphs(cont, hybrids, [(200, [0.4, 0.6])])
    jv0, v0 = _values(init)
    got, want = g.solve(v0), jg.solve(jv0)
    _same_result(got, want)
    assert got[1] == true_modes
    assert got[2][tuple(sorted(true_modes.items()))] > 0.99


def test_solve_beam_matches_jax(chain32):
    cont, hybrids, init, _, true_modes = chain32
    jg, g = _both_graphs(cont, hybrids)
    jv0, v0 = _values(init)
    got = g.solve_beam(v0, max_leaves=2)
    _same_result(got, jg.solve_beam(jv0, max_leaves=2))
    assert got[1] == true_modes


def smoother_problem(n=5, seed=0):
    """JAX TestHybridSmoother's stream: an SE(2) chain and two ambiguous
    closures (mode 0 the inlier)."""
    step = np.array([1.0, 0.0, 0.0])
    truth = [np.zeros(3)]
    for _ in range(n - 1):
        truth.append(_se2_compose(truth[-1], step))
    truth = np.stack(truth)
    init = truth + np.random.default_rng(seed).normal(0, 0.05, (n, 3))
    odo = [_jbatch("prior", 0, None, truth[0], 1e-4)] + [
        _jbatch("between", i, i + 1, _se2_between(truth[i], truth[i + 1]),
                0.1) for i in range(n - 1)]

    def closure(i, j, var):
        good = _se2_between(truth[i], truth[j])
        return _jhybrid("between", i, j, [good, good + [3.0, 1.0, 0.5]],
                        0.05, var)
    return odo, [closure(0, 3, 100), closure(1, 4, 101)], init, truth


def _port_smoother(odo, closures, init, max_leaves):
    sm = h.HybridSmoother(max_leaves=max_leaves)
    v0 = Values({"se2": torch.tensor(init, dtype=F64)})
    sm.update(v0, continuous=port_graph(JGraph(odo)).batches)
    for hf in closures:
        sm.update(v0, hybrids=[_port_hybrid(hf)])
    return sm


def test_smoother_matches_jax(chain32):
    """A two-update stream on the chain (the first ambiguous prior with the
    continuous factors, then the second) at the beam's Params: its graphs
    have the structures of solve_beam's two steps, so the JAX programs
    compiled above serve it."""
    cont, hybrids, init, _, true_modes = chain32
    params = dict(max_iterations=25)
    jsm = jh.HybridSmoother(max_leaves=2, params=jopt.Params(**params))
    jv0 = JValues({"se2": jnp.asarray(init)})
    jsm.update(jv0, continuous=cont, hybrids=hybrids[:1])
    jsm.update(jv0, hybrids=hybrids[1:])
    sm = h.HybridSmoother(max_leaves=2, params=opt.Params(**params))
    v0 = Values({"se2": torch.tensor(init, dtype=F64)})
    sm.update(v0, continuous=port_graph(JGraph(cont)).batches,
              hybrids=[_port_hybrid(hybrids[0])])
    sm.update(v0, hybrids=[_port_hybrid(hybrids[1])])
    got = sm.estimate()
    _same_result(got, jsm.estimate())
    assert got[1] == true_modes


def isam_problem(seed=7, n=8):
    """JAX TestHybridISAM's chain with three ambiguous loop closures."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((n, 3))
    for i in range(1, n):
        truth[i] = _se2_compose(truth[i - 1], np.array([1.0, 0.0, 0.15]))

    def meas(i, j):
        return _se2_between(truth[i], truth[j]) + rng.normal(scale=0.005,
                                                             size=3)
    odo = [meas(i - 1, i) for i in range(1, n)]
    init = [truth[i] + rng.normal(scale=0.05, size=3) for i in range(1, n)]
    closures = []
    for i, j in [(1, 4), (2, 6), (0, 7)]:
        good = meas(i, j)
        closures.append((i, j, good, good + np.array([2.0, -1.5, 0.8])))
    return truth, odo, init, closures


W = 1.0 / np.array([0.05, 0.05, 0.02])


def _drive_isam(hi, noise, problem, n_closures=3, factors=F):
    truth, odo, init, closures = problem
    rb = factors.make_between_residual("se2")
    pr = factors.make_prior_residual("se2")
    hi.add_variable("se2", truth[0])
    hi.add_factor("prior_se2", pr, ["se2"], 3, [0], {"prior": np.zeros(3)},
                  noise)
    hi.update()
    for i in range(1, len(truth)):
        hi.add_variable("se2", init[i - 1])
        hi.add_factor("between_se2", rb, ["se2", "se2"], 3, [i - 1, i],
                      {"measured": odo[i - 1]}, noise)
        hi.update()
    for k, (i, j, good, bad) in enumerate(closures[:n_closures]):
        hi.add_hybrid_factor("between_se2", rb, ["se2", "se2"], 3, [i, j],
                             [{"measured": good}, {"measured": bad}], noise,
                             mode_var=100 + k)
    for _ in range(6):
        hi.update()
    return hi.estimate()


def test_isam_matches_jax():
    problem = isam_problem()
    jhi = jh.HybridISAM(max_leaves=2, params=JISAM2Params(
        relinearize_threshold=0.0, cg_maxiter=60, cg_tol=1e-10,
        dtype=np.float64))
    want = _drive_isam(jhi, JNoise("diag", jnp.asarray(W)), problem, 2, JF)
    hi = h.HybridISAM(max_leaves=2, params=ISAM2Params(
        relinearize_threshold=0.0, cg_maxiter=60, cg_tol=1e-10,
        dtype=F64), device=CPU)
    got = _drive_isam(hi, NoiseModel("diag", torch.tensor(W)), problem, 2)
    _same_result(got, want)


# --- the port at the JAX test file's sizes -----------------------------------

def test_beam_matches_exact_small():
    cont, hybrids, init, _, true_modes = chain_problem(4, 3)
    _, g = _both_graphs(cont, hybrids)
    v0 = _values(init)[1]
    v_ex, a_ex, _ = g.solve(v0)
    v_bm, a_bm, _ = g.solve_beam(v0, max_leaves=8)
    assert a_ex == a_bm == true_modes
    np.testing.assert_allclose(v_bm["se2"].numpy(), v_ex["se2"].numpy(),
                               atol=1e-5)


def test_beam_many_mode_vars_bounded():
    """12 mode variables: 4096 joint assignments, the beam solves at most
    12 * 4 * 2 = 96 continuous problems."""
    cont, hybrids, init, truth, true_modes = chain_problem(6, 12)
    _, g = _both_graphs(cont, hybrids)
    v, a, _ = g.solve_beam(_values(init)[1], max_leaves=4)
    assert a == true_modes
    np.testing.assert_allclose(v["se2"].numpy()[:, :2], truth[:, :2],
                               atol=0.1)


def test_smoother_matches_batch():
    odo, closures, init, truth = smoother_problem()
    sm = _port_smoother(odo, closures, init, 3)
    v, a, _ = sm.estimate()
    assert a == {100: 0, 101: 0}
    np.testing.assert_allclose(v["se2"].numpy()[:, :2], truth[:, :2],
                               atol=0.05)
    _, g = _both_graphs(odo, closures)
    vb, ab, _ = g.solve(Values({"se2": torch.tensor(init, dtype=F64)}))
    assert ab == a
    np.testing.assert_allclose(v["se2"].numpy(), vb["se2"].numpy(),
                               atol=1e-4)


def test_isam_matches_enumeration():
    """HybridISAM picks the inlier of each of the three closures, and the
    exact enumeration of the same measurements agrees."""
    problem = isam_problem()
    truth, odo, init, closures = problem
    hi = h.HybridISAM(max_leaves=4, params=ISAM2Params(
        relinearize_threshold=0.0, cg_maxiter=60, cg_tol=1e-10,
        dtype=F64), device=CPU)
    vals, assign, post = _drive_isam(hi, NoiseModel("diag", torch.tensor(W)),
                                     problem)
    assert assign == {100: 0, 101: 0, 102: 0}
    assert post[tuple(sorted(assign.items()))] > 0.9
    b = JBuilder()
    noise = {"kind": "diag", "data": W}
    JF.add_prior(b, "se2", 0, np.zeros(3), noise)
    for i in range(1, len(truth)):
        JF.add_between(b, "se2", i - 1, i, odo[i - 1], noise)
    cont = b.build(dtype=jnp.float64).batches
    hybrids = []
    for k, (i, j, good, bad) in enumerate(closures):
        base = b.build(dtype=jnp.float64).batches[1]
        hybrids.append(jh.HybridFactor(
            JBatch(base.name, base.residual_fn, base.groups, 3,
                   jnp.asarray([[i, j]]),
                   {"measured": jnp.asarray(np.stack([good, bad]))[:, None]},
                   JNoise("diag", jnp.asarray(W[None]))),
            mode_var=100 + k, num_modes=2))
    _, g = _both_graphs(cont, hybrids)
    v_ex, a_ex, _ = g.solve(Values({"se2": torch.tensor(
        np.concatenate([truth[:1], np.stack(init)]), dtype=F64)}))
    assert a_ex == assign
    np.testing.assert_allclose(vals["se2"].numpy(), v_ex["se2"].numpy(),
                               atol=1e-6)


def test_clone_branches_are_independent():
    """Fork an engine, update one branch: the other's device state and
    estimate are unchanged bit for bit."""
    truth, odo, init, closures = isam_problem()
    rb = F.make_between_residual("se2")
    noise = NoiseModel("diag", torch.tensor(W))
    e = ISAM2(ISAM2Params(dtype=F64), device=CPU)
    e.add_variable("se2", truth[0])
    e.add_factor("prior_se2", F.make_prior_residual("se2"), ["se2"], 3, [0],
                 {"prior": np.zeros(3)}, noise)
    for i in range(1, 5):
        e.add_variable("se2", init[i - 1])
        e.add_factor("between_se2", rb, ["se2", "se2"], 3, [i - 1, i],
                     {"measured": odo[i - 1]}, noise)
        e.update()

    def snapshot(engine):
        st = engine._state
        out = {f"theta_{g}": t.clone() for g, t in st.theta.items()}
        out.update({f"delta_{g}": t.clone() for g, t in st.delta.items()})
        for k, b in enumerate(st.batches):
            out[f"r_{k}"] = b.r.clone()
            out[f"idx_{k}"] = b.idx.clone()
            for s, J in enumerate(b.J):
                out[f"J_{k}_{s}"] = J.clone()
            for m, v in b.meas.items():
                out[f"meas_{k}_{m}"] = v.clone()
        return out, engine.calculate_estimate()["se2"].clone()

    before, est = snapshot(e)
    branch = e.clone()
    i, j, good, bad = closures[0]
    branch.add_factor("between_se2", rb, ["se2", "se2"], 3, [i, j],
                      {"measured": bad}, noise)
    branch.add_variable("se2", init[4])
    branch.add_factor("between_se2", rb, ["se2", "se2"], 3, [4, 5],
                      {"measured": odo[4]}, noise)
    for _ in range(3):
        branch.update()
    after, est2 = snapshot(e)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    assert torch.equal(est, est2)
    assert not torch.equal(branch.calculate_estimate()["se2"][:5], est)
