"""The rest of the library against the JAX package, on the CPU in
float64: keys (exact), symbolic elimination and orderings (exact),
Chebyshev and Fourier bases (weights, differentiation matrix and
residuals to 1e-12, fit_basis to 1e-9), the QPS parser (exact arrays) and
solve_qps (1e-9), the tic/toc profiler, debug flags and the Graphviz
writer (same text)."""

import numpy as np
import pytest
import torch

from gtsam_personal_tpu.basis import chebyshev as jcheb
from gtsam_personal_tpu.core import keys as jkeys
from gtsam_personal_tpu.inference import symbolic as jsym
from gtsam_personal_tpu.io import qps as jqps
from gtsam_personal_tpu.slam import manhattan as jmanhattan
from gtsam_personal_tpu.utils import dot as jdot
from gtsam_personal_tpu_torch.basis import chebyshev as cheb
from gtsam_personal_tpu_torch.core import keys
from gtsam_personal_tpu_torch.inference import symbolic as sym
from gtsam_personal_tpu_torch.io import qps
from gtsam_personal_tpu_torch.utils import debug, dot, timing
from test_torch_graph import port_graph

CPU = "cpu"
X = np.array([-0.97, -0.3, 0.0, 0.41, 0.9999])


def test_keys_encode_decode():
    for mod in (keys, jkeys):
        assert mod.Symbol("x", 5).key() == jkeys.Symbol("x", 5).key()
    for c, i in [("x", 0), ("l", 12345), ("b", (1 << 56) - 1)]:
        k = keys.Symbol(c, i).key()
        assert k == jkeys.Symbol(c, i).key()
        assert repr(keys.Symbol(k)) == repr(jkeys.Symbol(k))
    ls = keys.LabeledSymbol("x", "a", 7)
    assert ls.key() == jkeys.LabeledSymbol("x", "a", 7).key()
    assert repr(keys.LabeledSymbol(ls.key())) == "xa7"
    e = keys.EdgeKey(3, (1 << 33) + 4)
    assert e.key() == jkeys.EdgeKey(3, (1 << 33) + 4).key()
    assert (keys.EdgeKey(e.key()).i, keys.EdgeKey(e.key()).j) == (3, 4)
    assert keys.symbol_shorthand.X(3) == keys.Symbol("x", 3)
    t, jt = keys.SymbolTable({"x": "se2", "l": "point2"}), \
        jkeys.SymbolTable({"x": "se2", "l": "point2"})
    seq = [keys.Symbol("x", 4), keys.Symbol("l", 1), keys.Symbol("x", 2),
           keys.Symbol("x", 4)]
    assert [t.resolve(s) for s in seq] == [jt.resolve(jkeys.Symbol(int(s)))
                                           for s in seq]
    assert t.counts() == jt.counts()


def _grid_factors(n=6, seed=0):
    rng = np.random.default_rng(seed)
    fs = [(i * n + j, i * n + j + 1) for i in range(n) for j in range(n - 1)]
    fs += [(i * n + j, (i + 1) * n + j) for i in range(n - 1)
           for j in range(n)]
    fs += [tuple(int(v) for v in rng.choice(n * n, 3, replace=False))
           for _ in range(5)]
    return fs


def test_symbolic_elimination_and_orderings():
    fs = _grid_factors()
    g, jg = sym.SymbolicFactorGraph(fs), jsym.SymbolicFactorGraph(fs)
    assert g.keys() == jg.keys()
    order = g.default_ordering()
    assert order == jg.default_ordering()
    kw = dict(constrained_last=[0, 7], constrained_first=[35])
    assert g.default_ordering(**kw) == jg.default_ordering(**kw)
    for o in (order, list(range(36))):
        bn, fill = g.eliminate(o)
        jbn, jfill = jg.eliminate(o)
        assert fill == jfill
        assert bn.conditionals == jbn.conditionals
        assert bn.clique_tree() == jbn.clique_tree()
    assert bn.parents(0) == jbn.parents(0)
    assert g.add(0, 35).factors[-1] == frozenset({0, 35})


@pytest.mark.parametrize("n,a,b", [(8, -1.0, 1.0), (12, 0.0, 3.0)])
def test_basis_weights(n, a, b):
    xs = a + (b - a) * (X + 1) / 2
    np.testing.assert_array_equal(cheb.chebyshev2_points(n, a, b),
                                  jcheb.chebyshev2_points(n, a, b))
    D = cheb.chebyshev2_differentiation_matrix(n, a, b, device=CPU)
    np.testing.assert_allclose(
        D.numpy(), np.asarray(jcheb.chebyshev2_differentiation_matrix(n, a,
                                                                      b)),
        rtol=1e-12, atol=1e-12)
    for x in list(xs) + [cheb.chebyshev2_points(n, a, b)[3]]:
        for name in ("chebyshev2_weights", "chebyshev2_derivative_weights"):
            got = getattr(cheb, name)(x, n, a, b, device=CPU)
            want = getattr(jcheb, name)(x, n, a, b)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-12)
    batch = cheb.chebyshev2_weights(torch.tensor(xs), n, a, b)
    assert batch.shape == (len(xs), n)
    np.testing.assert_allclose(
        cheb.chebyshev1_weights(xs, n, a, b, device=CPU).numpy(),
        np.asarray(jcheb.chebyshev1_weights(xs, n, a, b)), rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(
        cheb.fourier_weights(xs, n, device=CPU).numpy(),
        np.asarray(jcheb.fourier_weights(xs, n)), rtol=1e-12, atol=1e-12)


def test_basis_residuals():
    rng = np.random.default_rng(2)
    c = rng.normal(size=8)
    meas = {"w": rng.normal(size=8), "z": np.float64(0.3),
            "d": rng.normal(size=8)}
    tm = {k: torch.tensor(v) for k, v in meas.items()}
    for name in ("evaluation_residual", "derivative_residual"):
        got = getattr(cheb, name)((torch.tensor(c),), tm)
        want = getattr(jcheb, name)((c,), meas)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    C = rng.normal(size=6)
    vm = {"w": rng.normal(size=3), "d": rng.normal(size=3),
          "z": rng.normal(size=2)}
    for name in ("vector_evaluation_residual", "vector_derivative_residual"):
        got = getattr(cheb, name)(2)((torch.tensor(C),),
                                     {k: torch.tensor(v)
                                      for k, v in vm.items()})
        want = getattr(jcheb, name)(2)((C,), vm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


@pytest.mark.parametrize("basis", ["chebyshev2", "chebyshev1", "fourier"])
def test_fit_basis(basis):
    rng = np.random.default_rng(4)
    xs = np.sort(rng.uniform(-1, 1, 30))
    zs = np.sin(2 * xs) + 0.01 * rng.normal(size=30)
    got, res = cheb.fit_basis(xs, zs, 7, basis, device=CPU)
    want, jres = jcheb.fit_basis(xs, zs, 7, basis)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert abs(res.error - jres.error) <= 1e-9 * max(jres.error, 1e-12)


QPS_TEXT = """NAME          TINYQP
ROWS
 N  obj
 L  c1
 G  c2
 E  c3
COLUMNS
    x1        obj       -1.0       c1        1.0
    x1        c2        1.0        c3        1.0
    x2        obj       -2.0       c1        1.0
    x2        c3        -1.0
    x3        obj       0.5        c2        1.0
RHS
    rhs       obj       -1.5       c1        4.0
    rhs       c2        0.5        c3        0.2
RANGES
    rng       c1        3.0
BOUNDS
 UP bnd       x1        3.0
 LO bnd       x2        -1.0
 FR bnd       x3
QUADOBJ
    x1        x1        2.0
    x1        x2        0.5
    x2        x2        1.0
    x3        x3        4.0
ENDATA
"""


def test_qps_parse_and_solve(tmp_path):
    path = tmp_path / "tiny.qps"
    path.write_text(QPS_TEXT)
    got, want = qps.parse_qps(str(path)), jqps.parse_qps(str(path))
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    x, obj = qps.solve_qps(str(path))
    jx, jobj = jqps.solve_qps(str(path))
    np.testing.assert_allclose(x, jx, rtol=1e-9, atol=1e-12)
    assert abs(obj - jobj) <= 1e-9 * abs(jobj)


def test_timing_tree_and_sync():
    timing.reset()
    with timing.tic("outer"):
        for _ in range(3):
            with timing.tic("inner", sync=[torch.ones(2), {"a": CPU}]):
                pass
    text = timing.report().splitlines()
    assert text[0].split()[0] == "outer" and "(1 calls" in text[0]
    assert text[1].startswith("  inner") and "(3 calls" in text[1]
    timing.reset()
    assert timing.report() == ""


def test_debug_flags(capsys):
    debug.clear_debug()
    debug.debug_print("solver", "hidden")
    debug.set_debug("solver")
    assert debug.is_debug("solver") and not debug.is_debug("other")
    debug.debug_print("solver", "shown", 3)
    debug.clear_debug()
    assert capsys.readouterr().out == "[solver] shown 3\n"


def test_dot_matches_jax(tmp_path):
    jgraph, _, _ = jmanhattan.make_manhattan(60, seed=3)
    g = port_graph(jgraph)
    assert dot.to_dot(g, "m") == jdot.to_dot(jgraph, "m")
    dot.write_dot(g, str(tmp_path / "m.dot"))
    assert (tmp_path / "m.dot").read_text() == jdot.to_dot(jgraph)
