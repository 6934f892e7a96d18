"""The port's Gaussian conditionals and Bayes net (linear/conditional.py)
against the JAX package, in float64 on the CPU: the ten cases of
tests/test_conditional.py on a 100-pose Manhattan world (seed 3, a prior
and six loop closures) standing in for w100.graph, and the two
exact-constraint cases of tests/test_constrained_noise.py:79-112. Sampling
takes the JAX key's white noise: the draws are passed across as numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.values import Layout as JLayout
from gtsam_personal_tpu.linear import conditional as JC
from gtsam_personal_tpu.linear import linearize as jlin
from gtsam_personal_tpu.linear.linearize import (GaussianGraph as JGG,
                                                 LinearBatch as JLB)
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu.slam import manhattan as jmanhattan
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Layout, Values, tree_vdot
from gtsam_personal_tpu_torch.linear import conditional as C
from gtsam_personal_tpu_torch.linear import noise, solvers
from gtsam_personal_tpu_torch.linear.linearize import (GaussianGraph,
                                                       LinearBatch, linearize)
from gtsam_personal_tpu_torch.nonlinear import optimizers as opt
from test_constrained_noise import _toy_constrained_graph as j_toy
from test_torch_graph import port_graph, port_values

F64 = torch.float64
N_POSES = 100
LAM = 1e-6


class Case:
    def __init__(self):
        self.jgraph, self.jvalues, _ = jmanhattan.make_manhattan(N_POSES,
                                                                 seed=3)
        self.graph = port_graph(self.jgraph)
        self.values = port_values(self.jvalues)
        self.jlin = jax.jit(jlin.linearize)(self.jgraph, self.jvalues)
        self.lin = linearize(self.graph, self.values)
        self.layout = Layout.of(self.values)
        self.jlayout = JLayout.of(self.jvalues)


@pytest.fixture(scope="module")
def case():
    return Case()


def _flat(layout, delta):
    return layout.flatten(delta).numpy()


def test_backsub_equals_dense(case):
    bn = C.eliminate_sequential(case.lin, case.layout, lam=LAM)
    d_bn = _flat(case.layout, bn.optimize())
    d_dense = _flat(case.layout, solvers.solve_dense(case.lin, case.layout,
                                                     LAM))
    np.testing.assert_allclose(d_bn, d_dense, rtol=1e-8, atol=1e-10)
    jbn = JC.eliminate_sequential(case.jlin, case.jlayout, lam=LAM)
    np.testing.assert_allclose(bn.Rmat.numpy(), np.asarray(jbn.Rmat),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(d_bn, np.asarray(
        case.jlayout.flatten(jbn.optimize())), rtol=1e-10, atol=1e-12)


def test_qr_equals_cholesky(case):
    d_ch = _flat(case.layout, C.eliminate_sequential(
        case.lin, case.layout, lam=LAM).optimize())
    d_qr = _flat(case.layout, C.solve_qr(case.lin, case.layout, lam=LAM))
    np.testing.assert_allclose(d_qr, d_ch, rtol=1e-7, atol=1e-9)
    jd = np.asarray(case.jlayout.flatten(JC.solve_qr(case.jlin, case.jlayout,
                                                     lam=LAM)))
    np.testing.assert_allclose(d_qr, jd, rtol=1e-10, atol=1e-12)


def test_qr_R_matches_cholesky_R(case):
    """Both factorizations give the same canonical upper factor R
    (diag > 0), and each equals the JAX package's."""
    bn_ch = C.eliminate_sequential(case.lin, case.layout, method="cholesky")
    bn_qr = C.eliminate_sequential(case.lin, case.layout, method="qr")
    np.testing.assert_allclose(bn_qr.Rmat.numpy(), bn_ch.Rmat.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn_qr.dvec.numpy(), bn_ch.dvec.numpy(),
                               rtol=1e-5, atol=1e-7)
    jbn = JC.eliminate_sequential(case.jlin, case.jlayout, method="qr")
    np.testing.assert_allclose(bn_qr.Rmat.numpy(), np.asarray(jbn.Rmat),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(bn_qr.dvec.numpy(), np.asarray(jbn.dvec),
                               rtol=1e-9, atol=1e-9)


def test_stepwise_conditionals_match(case):
    """GaussianConditional.solve one variable at a time == the one-shot
    triangular solve."""
    bn = C.eliminate_sequential(case.lin, case.layout, lam=LAM)
    np.testing.assert_allclose(_flat(case.layout, bn.optimize_stepwise()),
                               _flat(case.layout, bn.optimize()),
                               rtol=1e-8, atol=1e-10)
    c = bn.conditional(7)
    assert (c.group, c.index, c.off, c.dim) == ("se2", 7, 21, 3)
    assert len(bn) == N_POSES


def test_backsubstitute_roundtrips(case):
    bn = C.eliminate_sequential(case.lin, case.layout, lam=LAM)
    jbn = JC.eliminate_sequential(case.jlin, case.jlayout, lam=LAM)
    rng = np.random.default_rng(0)
    rhs_np = rng.standard_normal((N_POSES, 3))
    rhs = {"se2": torch.tensor(rhs_np)}
    iperm = torch.as_tensor(bn._iperm)
    x = bn.back_substitute(rhs)
    back = case.layout.unflatten((bn.Rmat @ bn._permute(x))[iperm])
    np.testing.assert_allclose(back["se2"].numpy(), rhs_np, rtol=1e-8,
                               atol=1e-9)
    xt = bn.back_substitute_transpose(rhs)
    backt = case.layout.unflatten((bn.Rmat.T @ bn._permute(xt))[iperm])
    np.testing.assert_allclose(backt["se2"].numpy(), rhs_np, rtol=1e-8,
                               atol=1e-9)
    jrhs = {"se2": jnp.asarray(rhs_np)}
    for got, ref in ((x, jbn.back_substitute(jrhs)),
                     (xt, jbn.back_substitute_transpose(jrhs))):
        np.testing.assert_allclose(got["se2"].numpy(), np.asarray(ref["se2"]),
                                   rtol=1e-9, atol=1e-9)


def test_gradient_search_is_cauchy_point(case):
    """optimize_gradient_search == (g.g / g^T H g) g from the graph."""
    bn = C.eliminate_sequential(case.lin, case.layout)
    sd = bn.optimize_gradient_search()
    g = {k: -x for k, x in case.lin.gradient_at_zero().items()}
    alpha = float(tree_vdot(g, g)) / float(tree_vdot(
        g, case.lin.hessian_vector_product(g)))
    np.testing.assert_allclose(sd["se2"].numpy(), alpha * g["se2"].numpy(),
                               rtol=1e-6, atol=1e-9)
    jsd = JC.eliminate_sequential(case.jlin,
                                  case.jlayout).optimize_gradient_search()
    np.testing.assert_allclose(sd["se2"].numpy(), np.asarray(jsd["se2"]),
                               rtol=1e-9, atol=1e-12)


def test_sampling_covariance_small():
    """The draws for the JAX keys' white noise equal the JAX package's
    samples; their covariance ~ (R^T R)^{-1}; and a torch.Generator's
    draws have it too (reference: GaussianBayesNet::sample)."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((8, 4))
    H = A.T @ A + 0.5 * np.eye(4)
    g = rng.standard_normal(4)
    L = np.linalg.cholesky(H)
    R, d = L.T, np.linalg.solve(L, -g)
    layout, jlayout = Layout({"r2": 2}), JLayout({"r2": 2})
    order, perm = C._make_order(layout, None)
    bn = C.GaussianBayesNet(torch.tensor(R), torch.tensor(d), order, layout,
                            perm)
    jorder, jperm = JC._make_order(jlayout, None)
    assert jorder == order and (jperm == perm).all()
    jbn = JC.GaussianBayesNet(jnp.asarray(R), jnp.asarray(d), jorder,
                              jlayout, jperm)
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    eps = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (4,), dtype=jnp.float64))(keys))
    jS = np.asarray(jax.vmap(lambda k: jbn.sample(k)["r2"].ravel())(keys))
    S = np.stack([bn.sample_from(torch.tensor(e))["r2"].numpy().ravel()
                  for e in eps])
    np.testing.assert_allclose(S, jS, rtol=1e-10, atol=1e-12)
    mean = layout.flatten(bn.optimize()).numpy()
    np.testing.assert_allclose(S.mean(axis=0), mean, atol=0.1)
    np.testing.assert_allclose(np.cov(S.T), np.linalg.inv(H), atol=0.15)
    gen = torch.Generator().manual_seed(0)
    St = np.stack([bn.sample(gen)["r2"].numpy().ravel()
                   for _ in range(4000)])
    np.testing.assert_allclose(St.mean(axis=0), mean, atol=0.1)
    np.testing.assert_allclose(np.cov(St.T), np.linalg.inv(H), atol=0.15)


def test_logdet(case):
    bn = C.eliminate_sequential(case.lin, case.layout, lam=LAM)
    H, _ = case.lin.assemble_dense(case.layout)
    sign, logdet_H = np.linalg.slogdet(H.numpy()
                                       + LAM * np.eye(case.layout.total_dim))
    assert sign > 0
    np.testing.assert_allclose(float(bn.log_determinant()), 0.5 * logdet_H,
                               rtol=1e-8)
    jbn = JC.eliminate_sequential(case.jlin, case.jlayout, lam=LAM)
    assert float(bn.log_determinant()) == pytest.approx(
        float(jbn.log_determinant()), rel=1e-12)
    delta = bn.optimize()
    assert float(bn.error(delta)) == pytest.approx(0.0, abs=1e-18)


def test_qr_solver_in_lm(case):
    """Params(solver="qr") in optimize_lm against the JAX package's, at the
    dense solver's fixed point."""
    ref = jopt.optimize_lm(case.jgraph, case.jvalues,
                           jopt.Params(solver="qr", max_iterations=15,
                                       diagnose_on_failure=False))
    res = opt.optimize_lm(case.graph, case.values,
                          opt.Params(solver="qr", max_iterations=15))
    assert res.iterations == ref.iterations
    assert res.error == pytest.approx(ref.error, rel=1e-9)
    # the fixed point of the normal equations' solver
    dense = opt.optimize_lm(case.graph, case.values,
                            opt.Params(max_iterations=15))
    assert res.error == pytest.approx(dense.error, rel=1e-9)


def test_qr_beats_normal_equations_conditioning():
    """On an ill-conditioned Jacobian (cond 1e7) QR recovers the solution
    where the normal equations lose half the digits."""
    rng = np.random.default_rng(2)
    n = 12
    U, _ = np.linalg.qr(rng.standard_normal((40, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = U @ np.diag(np.logspace(0, -7, n)) @ V.T
    x_true = rng.standard_normal(n)
    b = -(A @ x_true)
    nv = n // 3
    idx = np.arange(nv)[None, :]
    lin = GaussianGraph([LinearBatch(
        ("r3",) * nv, torch.tensor(idx),
        tuple(torch.tensor(A[None, :, 3 * s:3 * s + 3]) for s in range(nv)),
        torch.tensor(b[None, :]))], {"r3": nv})
    layout = Layout({"r3": nv})
    x_qr = layout.flatten(C.solve_qr(lin, layout)).numpy()
    err_qr = np.linalg.norm(x_qr - x_true) / np.linalg.norm(x_true)
    x_ch = layout.flatten(solvers.solve_dense(lin, layout)).numpy()
    err_ch = np.linalg.norm(x_ch - x_true) / np.linalg.norm(x_true)
    assert err_qr < 1e-6, err_qr
    assert err_qr < err_ch * 1e-2 or err_ch < 1e-9, (err_qr, err_ch)
    jlin_ = JGG([JLB(("r3",) * nv, jnp.asarray(idx, dtype=jnp.int32),
                     tuple(jnp.asarray(A[None, :, 3 * s:3 * s + 3])
                           for s in range(nv)), jnp.asarray(b[None, :]))],
                {"r3": nv})
    jl = JLayout({"r3": nv})
    jx = np.asarray(jl.flatten(JC.solve_qr(jlin_, jl)))
    np.testing.assert_allclose(x_qr, jx, rtol=0, atol=1e-8)


# --- exact equality constraints (tests/test_constrained_noise.py:79-112) -----

def _toy(mu=1000.0):
    """test_constrained_noise.py's toy: soft priors pull x0 to (1, 1) and x1
    to (-1, 0); a between factor holds (x1 - x0)[0] == 3 exactly and
    [1] == 0 softly."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float64))
    prior = lambda xs, m: xs[0] - m["p"]
    between = lambda xs, m: (xs[1] - xs[0]) - m["m"]
    graph = FactorGraph([
        FactorBatch("prior0", prior, ("r2",), 2, torch.tensor([[0]]),
                    {"p": t([[1.0, 1.0]])}, noise.NoiseModel(
                        "diag", t([2.0, 2.0]))),
        FactorBatch("prior1", prior, ("r2",), 2, torch.tensor([[1]]),
                    {"p": t([[-1.0, 0.0]])}, noise.NoiseModel(
                        "diag", t([2.0, 2.0]))),
        FactorBatch("between01", between, ("r2", "r2"), 2,
                    torch.tensor([[0, 1]]), {"m": t([[3.0, 0.0]])},
                    noise.constrained_sigmas([0.0, 0.5], mu, device="cpu",
                                             dtype=F64))])
    return graph, Values({"r2": t(np.zeros((2, 2)))})


def test_exact_equality_constrained_solve():
    graph, values = _toy()
    layout = Layout.of(values)
    lin, E, e = C.split_constrained(graph, values, layout)
    assert tuple(E.shape) == (1, 4)
    x = layout.flatten(C.solve_equality_constrained(lin, layout, E, e)
                       ).numpy().reshape(2, 2)
    np.testing.assert_allclose(x[1, 0] - x[0, 0], 3.0, atol=1e-12)
    np.testing.assert_allclose(x[0, 0], -1.5, atol=1e-9)
    np.testing.assert_allclose(x[1, 0], 1.5, atol=1e-9)
    jg, jv = j_toy()
    jl = JLayout.of(jv)
    jlin_, jE, je = JC.split_constrained(jg, jv, jl)
    np.testing.assert_allclose(E.numpy(), np.asarray(jE), atol=0)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=0)
    jx = np.asarray(jl.flatten(JC.solve_equality_constrained(jlin_, jl, jE,
                                                             je)))
    np.testing.assert_allclose(x.ravel(), jx, rtol=0, atol=1e-12)


def test_penalty_solution_approaches_exact():
    """The penalty form converges to the exact constrained solution as mu
    grows (and is close already at the reference's mu = 1000)."""
    graph, values = _toy()
    layout = Layout.of(values)
    lin, E, e = C.split_constrained(graph, values, layout)
    exact = layout.flatten(C.solve_equality_constrained(lin, layout, E, e))
    pen = layout.flatten(solvers.solve_dense(linearize(graph, values),
                                             layout))
    assert float((pen - exact).abs().max()) < 1e-2
    g2, v2 = _toy(mu=1e8)
    pen2 = layout.flatten(solvers.solve_dense(linearize(g2, v2), layout))
    assert float((pen2 - exact).abs().max()) < 1e-6
