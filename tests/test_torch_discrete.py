"""The port's discrete inference and CSP solving (gtsam_personal_tpu_torch.
discrete) against the JAX package's, on the CPU in float64: the same
seeded tables go through both. Marginals, elimination tables, k_best
values and the Bayes net's evaluations to 1e-12; MPE assignments, k_best
orders, samples and CSP results exactly."""

import itertools

import jax
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.discrete import csp as jcsp, discrete as jd
from gtsam_personal_tpu_torch.discrete import csp, discrete as d

CPU = "cpu"


def _random_factors(seed, n_vars=8, n_factors=12):
    """Seeded potentials on 1-3 variables of cardinality 2 or 3 (8
    variables: the joint table of k_best stays small, and the JAX side's
    eager elimination quick)."""
    rng = np.random.default_rng(seed)
    cards = rng.integers(2, 4, n_vars)
    out = []
    for v in range(n_vars):                 # every variable appears
        out.append(((v,), rng.uniform(0.2, 2.0, cards[v])))
    for _ in range(n_factors - n_vars):
        vs = tuple(int(x) for x in rng.choice(n_vars, rng.integers(2, 4),
                                              replace=False))
        out.append((vs, rng.uniform(0.1, 3.0, tuple(cards[list(vs)]))))
    return out


def _both(factors):
    jg = jd.DiscreteFactorGraph()
    for vs, t in factors:
        jg.add(vs, t)
    return jg, d.factor_graph_from_numpy(factors, device=CPU)


@pytest.fixture(scope="module", params=[0, 1])
def graphs(request):
    return _both(_random_factors(request.param))


def test_marginals(graphs):
    jg, g = graphs
    for v in g.variables()[::3]:
        np.testing.assert_allclose(g.marginal(v).numpy(),
                                   np.asarray(jg.marginal(v)), rtol=1e-12,
                                   atol=1e-12)


def test_mpe(graphs):
    jg, g = graphs
    assert g.optimize() == jg.optimize()
    order = list(reversed(g.variables()))
    assert g.optimize(order) == jg.optimize(order)


def test_k_best(graphs):
    jg, g = graphs
    got, want = g.k_best(7), jg.k_best(7)
    assert [a for a, _ in got] == [a for a, _ in want]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want],
                               rtol=1e-12)


@pytest.mark.parametrize("mode", ["sum", "max"])
def test_eliminate_tables(graphs, mode):
    jg, g = graphs
    order = g.variables()[:5]
    bn, rest = g.eliminate(order, mode)
    jbn, jrest = jg.eliminate(order, mode)
    assert len(bn.conditionals) == len(jbn.conditionals)
    for c, jc in zip(bn.conditionals, jbn.conditionals):
        assert (c.frontal, c.parents) == (jc.frontal, jc.parents)
        np.testing.assert_allclose(c.table.numpy(), np.asarray(jc.table),
                                   rtol=1e-12, atol=1e-15)
    assert [f.vars for f in rest] == [f.vars for f in jrest]
    a = {v: 0 for v in g.variables()}
    assert abs(bn.evaluate(a) - jbn.evaluate(a)) <= 1e-12 * abs(
        jbn.evaluate(a))
    assert abs(g.evaluate(a) - jg.evaluate(a)) <= 1e-12 * jg.evaluate(a)


def _jax_uniforms(jbn, key, fixed):
    """The uniforms that JAX's DiscreteBayesNet.sample draws from `key`:
    one split and one uniform per conditional not fixed, in its order."""
    us = []
    for cond in reversed(jbn.conditionals):
        if cond.frontal in fixed:
            continue
        key, sub = jax.random.split(key)
        us.append(float(jax.random.uniform(sub, (), dtype=np.float64)))
    return us


@pytest.mark.parametrize("fixed", [{}, {3: 1}])
def test_sample_with_jax_uniforms(graphs, fixed):
    jg, g = graphs
    bn, _ = g.eliminate(g.variables())
    jbn, _ = jg.eliminate(jg.variables())
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = jbn.sample(key, dict(fixed))
        got = bn.sample_from_uniforms(_jax_uniforms(jbn, key, fixed),
                                      dict(fixed))
        assert got == want
        assert all(got[v] == m for v, m in fixed.items())


def test_sample_generator_follows_probabilities():
    g = d.DiscreteFactorGraph(CPU)
    g.add((0,), [0.2, 0.8])
    bn, _ = g.eliminate([0])
    gen = torch.Generator().manual_seed(0)
    counts = np.bincount([bn.sample(gen)[0] for _ in range(400)],
                         minlength=2)
    assert 0.7 < counts[1] / 400 < 0.9


def test_signature_cpt_and_asia():
    """parse_signature / cpt tables equal; the Asia network's MPE and
    marginals equal."""
    specs = [("99/1", 0, (), None), ("50/50", 1, (), None),
             ("99/1 95/5", 2, (0,), (2,)), ("99/1 90/10", 3, (1,), (2,)),
             ("70/30 40/60", 4, (1,), (2,)),
             ("1/0 0/1 0/1 0/1", 5, (2, 3), (2, 2)),
             ("95/5 2/98", 6, (5,), (2,)),
             ("9/1 2/8 3/7 1/9", 7, (5, 4), (2, 2))]
    jg, g = jd.DiscreteFactorGraph(), d.DiscreteFactorGraph(CPU)
    for spec, f, ps, cards in specs:
        jc = jd.parse_signature(spec, f, ps, cards)
        c = d.parse_signature(spec, f, ps, cards, device=CPU)
        np.testing.assert_allclose(c.table.numpy(), np.asarray(jc.table),
                                   rtol=1e-15)
        jg.add((f,) + ps, jc.table)
        g.add((f,) + ps, c.table)
    assert g.optimize() == jg.optimize()
    for v in range(8):
        np.testing.assert_allclose(g.marginal(v).numpy(),
                                   np.asarray(jg.marginal(v)), rtol=1e-12)
    with pytest.raises(ValueError, match="rows"):
        d.parse_signature("1/2 3/4", 0, (1,), (3,), device=CPU)


def test_csp_arc_consistency_and_assignment():
    def build(mod, **kw):
        p = mod.CSP(**kw)
        for v, c in enumerate([3, 3, 3, 2]):
            p.add_variable(v, c)
        p.add_all_diff([0, 1, 2])
        p.add_single_value(0, 2)
        p.add_domain(1, [1, 2])
        p.add_constraint_table([2, 3], [[1, 0], [0, 1], [1, 1]])
        return p

    jp, p = build(jcsp), build(csp, device=CPU)
    dom, jdom = p.run_arc_consistency(), jp.run_arc_consistency()
    assert dom.keys() == jdom.keys()
    for v in dom:
        np.testing.assert_array_equal(dom[v], jdom[v])
    sol = p.optimal_assignment()
    assert sol == jp.optimal_assignment()
    assert p.is_satisfied(sol)


def test_scheduler():
    def build(mod, **kw):
        s = mod.Scheduler(3, ["Frank", "Harvey", "Ron", "Ken"], **kw)
        s.add_student("Alice", {"AI": ["Frank", "Harvey"],
                                "Robotics": ["Ron", "Frank"]},
                      advisor="Frank")
        s.add_student("Bob", {"Vision": ["Ken", "Harvey"]},
                      available_slots=[0, 2])
        s.add_student("Carol", {"AI": ["Harvey", "Ken"],
                                "Vision": ["Ken", "Ron"]})
        return s

    assert build(csp, device=CPU).schedule() == build(jcsp).schedule()


def test_factor_value_and_brute_force_k_best():
    """k_best against brute force over the joint domain of a small
    graph."""
    _, g = _both(_random_factors(5, n_vars=5, n_factors=8))
    vs = g.variables()
    cards = {v: f.cardinality(v) for f in g.factors for v in f.vars}
    scored = sorted(((g.evaluate(dict(zip(vs, c))), c) for c in
                     itertools.product(*[range(cards[v]) for v in vs])),
                    reverse=True)
    best = g.k_best(3)
    for (p, c), (a, q) in zip(scored, best):
        assert a == dict(zip(vs, c))
        assert abs(p - q) <= 1e-12 * p
