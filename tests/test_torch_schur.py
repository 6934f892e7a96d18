"""The port's native symbolic helpers, graph partitioning, Schur plan and
linear solvers against the JAX package, in float64 on the CPU, on a 300-pose
Manhattan-world graph cut into parts of at most 32 poses (several parts and
a separator)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu import native as jnative
from gtsam_personal_tpu.core import values as jvalues_mod
from gtsam_personal_tpu.inference import partition as jpart
from gtsam_personal_tpu.linear import linearize as jlin, schur as jschur
from gtsam_personal_tpu.slam import manhattan as jmanhattan
from gtsam_personal_tpu_torch import native
from gtsam_personal_tpu_torch.core import values as values_mod
from gtsam_personal_tpu_torch.inference import partition as part
from gtsam_personal_tpu_torch.linear import (linearize as lin_mod, schur,
                                             solvers)
from test_torch_graph import port_graph, port_values

N_POSES, MAX_PART = 300, 32


class Case:
    def __init__(self):
        self.jgraph, self.jvalues, self.truth = jmanhattan.make_manhattan(
            N_POSES, seed=3)
        self.graph = port_graph(self.jgraph)
        self.values = port_values(self.jvalues)
        self.counts = {"se2": N_POSES}
        self.jplan = jschur.make_plan(self.jgraph, self.counts, MAX_PART)
        self.plan = schur.make_plan(self.graph, self.counts, MAX_PART)
        self.jlin = jax.jit(jlin.linearize)(self.jgraph, self.jvalues)
        self.lin = lin_mod.linearize(self.graph, self.values)
        self.layout = values_mod.Layout.of(self.values)


@pytest.fixture(scope="module")
def case():
    return Case()


def _flat(case, delta):
    return case.layout.flatten(delta).numpy()


# --- native ------------------------------------------------------------------

@pytest.fixture(scope="module")
def csr(case):
    _, A = part.build_adjacency(case.graph, case.counts)
    return A.indptr.astype(np.int64), A.indices.astype(np.int64)


def test_native_library_builds_outside_the_package():
    lib = native.get_lib()
    assert lib, "g++ is present here: the library must build"
    path = native.library_path()
    assert path.exists() and path.parent.name == "native"
    assert path.parent.parent.name == "build"
    pkg = native._SRC.parent
    assert not list(pkg.glob("*.so"))


def test_native_without_compiler_or_with_broken_source(tmp_path, monkeypatch):
    """No g++ and nothing built: None, and callers take the numpy versions.
    A g++ that fails on the source raises with the compiler's messages."""
    uncached = native.get_lib.__wrapped__
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert uncached() is None
    monkeypatch.undo()
    bad = tmp_path / "symbolic.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on symbolic.cpp"):
        uncached()
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_bfs_levels(csr):
    indptr, indices = csr
    rng = np.random.default_rng(0)
    mask = rng.random(N_POSES) < 0.8
    start = int(np.flatnonzero(mask)[5])
    got = native.bfs_levels(indptr, indices, mask, start)
    np.testing.assert_array_equal(
        got, native.bfs_levels_np(indptr, indices, mask, start))
    np.testing.assert_array_equal(
        got, jnative.bfs_levels(indptr, indices, mask, start))
    assert got[start] == 0 and (got[~mask] == -1).all()
    masked_start = int(np.flatnonzero(~mask)[0])
    assert (native.bfs_levels(indptr, indices, mask, masked_start) == -1).all()
    assert (native.bfs_levels_np(indptr, indices, mask, masked_start)
            == -1).all()


def test_native_classify_factors(case):
    vids = part.batch_vids(case.graph.batches[1], part.VarIndex(case.counts))
    rng = np.random.default_rng(1)
    # a valid labelling: both ends of a factor in one part, or one of them
    # in the separator (-1)
    part_of = np.repeat(np.arange(N_POSES // 50 + 1), 50)[:N_POSES]
    crossing = part_of[vids[:, 0]] != part_of[vids[:, 1]]
    part_of = part_of.astype(np.int64)
    part_of[vids[crossing, 1]] = -1
    part_of[rng.integers(N_POSES, size=10)] = -1
    got = native.classify_factors(vids, part_of)
    np.testing.assert_array_equal(got,
                                  native.classify_factors_np(vids, part_of))
    np.testing.assert_array_equal(got,
                                  jnative.classify_factors(vids, part_of))
    bad = np.arange(N_POSES) % 2
    for fn in (native.classify_factors, native.classify_factors_np):
        with pytest.raises(ValueError, match="spans two interior parts"):
            fn(vids, bad)
    with pytest.raises(ValueError, match="out of range"):
        native.classify_factors(vids, part_of[:10])


@pytest.mark.parametrize("grouped", [False, True])
def test_native_orderings(csr, grouped, monkeypatch):
    """The native orderings equal the JAX package's; the numpy versions
    (another, simpler algorithm) equal the JAX package's numpy versions.
    Both are permutations, and the grouped one keeps the groups in order."""
    indptr, indices = csr
    group = (np.arange(N_POSES) // 100).astype(np.int64)
    if grouped:
        args = (indptr, indices, group)
        fn, fn_np, jfn = (native.min_degree_order_grouped,
                          native.min_degree_order_grouped_np,
                          jnative.min_degree_order_grouped)
    else:
        args = (indptr, indices)
        fn, fn_np, jfn = (native.min_degree_order,
                          native.min_degree_order_np,
                          jnative.min_degree_order)
    assert jnative.get_lib(), "the JAX package's library must build here"
    got = fn(*args)
    np.testing.assert_array_equal(got, jfn(*args))
    got_np = fn_np(*args)
    monkeypatch.setattr(jnative, "_lib", False)   # its numpy fallback
    np.testing.assert_array_equal(got_np, jfn(*args))
    for perm in (got, got_np):
        np.testing.assert_array_equal(np.sort(perm), np.arange(N_POSES))
        if grouped:
            assert (np.diff(group[perm]) >= 0).all()


def test_native_refuses_a_broken_csr(csr):
    indptr, indices = csr
    bad = indices.copy()
    bad[3] = N_POSES + 7
    with pytest.raises(ValueError, match="out of range"):
        native.min_degree_order(indptr, bad)
    with pytest.raises(ValueError, match="CSR row pointer"):
        native.bfs_levels(indptr[:-1], indices, np.ones(N_POSES - 1, bool), 0)


# --- partition and plan -----------------------------------------------------

def test_partition_matches(case):
    p = part.partition_graph(case.graph, case.counts, MAX_PART)
    jp = jpart.partition_graph(case.jgraph, case.counts, MAX_PART)
    assert p.num_parts == jp.num_parts >= 2 and p.separator.size > 0
    for a, b in zip(p.parts, jp.parts):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(p.separator, jp.separator)
    np.testing.assert_array_equal(p.part_of, jp.part_of)
    assert p.stats() == jp.stats()
    seen = np.concatenate([*p.parts, p.separator])
    np.testing.assert_array_equal(np.sort(seen), np.arange(N_POSES))


def test_schur_plan_tables_equal(case):
    plan, jplan = case.plan, case.jplan
    assert plan.stats() == jplan.stats()
    assert plan.p >= 2 and plan.S_dim > 0 and plan.sd_max > 0
    np.testing.assert_array_equal(plan.D, jplan.D)

    def eq(a, b):
        assert a.dtype in (torch.int64, torch.bool)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    for k in ("fronts", "rhs", "ssys", "srhs"):
        eq(plan.asm[k], jplan.asm[k])
    eq(plan.l2g, jplan.l2g)
    assert len(plan.ea_buckets) == len(jplan.ea_buckets)
    for eb, jeb in zip(plan.ea_buckets, jplan.ea_buckets):
        assert eb["sdb"] == jeb["sdb"]
        for k in ("ids", "tgt", "tgt_rhs"):
            eq(eb[k], jeb[k])
    assert sorted(plan.sol_maps) == sorted(jplan.sol_maps)
    for g, smap in plan.sol_maps.items():
        assert smap["dim"] == jplan.sol_maps[g]["dim"]
        for k in ("part", "row", "in_sep", "sep_pos"):
            eq(smap[k], jplan.sol_maps[g][k])
    for bp, jbp in zip(plan.batch_plans, jplan.batch_plans):
        eq(bp["front_sel"], jbp["front_sel"])
        eq(bp["sep_sel"], jbp["sep_sel"])


def test_schur_plan_refuses_a_factor_across_two_interiors(case):
    p = part.partition_graph(case.graph, case.counts, MAX_PART)
    moved = p.separator[0]
    broken = part.Partition(
        [np.sort(np.append(p.parts[0], moved))] + p.parts[1:],
        p.separator[1:], p.vi)
    with pytest.raises(ValueError, match="spans two interior parts"):
        schur.SchurPlan(case.graph, case.counts, broken)


# --- solves ------------------------------------------------------------------

@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_solve_partitioned(case, lam):
    d = schur.solve_partitioned(case.lin, case.plan, lam)
    jd = jax.jit(lambda lin, lam: jschur.solve_partitioned(
        lin, case.jplan, lam))(case.jlin, lam)
    np.testing.assert_allclose(d["se2"].numpy(), np.asarray(jd["se2"]),
                               rtol=1e-9, atol=1e-12)
    dense = solvers.solve_dense(case.lin, case.layout, lam)
    np.testing.assert_allclose(_flat(case, d), _flat(case, dense), atol=1e-8)
    # a 0-dim tensor for lambda is the same as a float
    d_t = schur.solve_partitioned(case.lin, case.plan,
                                  torch.tensor(lam, dtype=torch.float64))
    np.testing.assert_array_equal(d_t["se2"].numpy(), d["se2"].numpy())


def test_solve_dense_matches(case):
    from gtsam_personal_tpu.linear import solvers as jsolvers
    jlayout = jvalues_mod.Layout.of(case.jvalues)
    jd = jax.jit(lambda lin: jsolvers.solve_dense(lin, jlayout, 1e-3))(
        case.jlin)
    d = solvers.solve_dense(case.lin, case.layout, 1e-3)
    np.testing.assert_allclose(d["se2"].numpy(), np.asarray(jd["se2"]),
                               rtol=1e-9, atol=1e-12)
    # diagonal damping: (H + lam diag(H)) delta = -g
    dd = case.layout.flatten(case.lin.hessian_diagonal())
    d2 = solvers.solve_dense(case.lin, case.layout, 0.1, dd)
    H, g = case.lin.assemble_dense(case.layout)
    ref = torch.linalg.solve(H + 0.1 * torch.diag(dd), -g)
    np.testing.assert_allclose(_flat(case, d2), ref.numpy(), atol=1e-9)


def test_single_part_no_separator(case):
    plan = schur.make_plan(case.graph, case.counts, max_part_size=1000)
    assert plan.S_dim == 0 and plan.p == 1 and plan.sd_max == 0
    d = schur.solve_partitioned(case.lin, plan)
    dense = solvers.solve_dense(case.lin, case.layout)
    np.testing.assert_allclose(_flat(case, d), _flat(case, dense), atol=1e-8)


def test_solve_pcg_matches_dense(case):
    """Block-Jacobi PCG needs ~700 iterations on this 900-dim system, so
    the cap is raised above the default of 250."""
    lam = 1e-3
    dense = solvers.solve_dense(case.lin, case.layout, lam)
    d = solvers.solve_pcg(case.lin, lam, maxiter=2000, tol=1e-12)
    np.testing.assert_allclose(_flat(case, d), _flat(case, dense), atol=1e-6)
    dd = case.lin.hessian_diagonal()
    d2 = solvers.solve_pcg(case.lin, 0.1, dd, maxiter=2000, tol=1e-12)
    dense2 = solvers.solve_dense(case.lin, case.layout, 0.1,
                                 case.layout.flatten(dd))
    np.testing.assert_allclose(_flat(case, d2), _flat(case, dense2),
                               atol=1e-6)


def test_pcg_masked_loop_equals_exact_stop(case, monkeypatch):
    """Reading the stop flag every 8 iterations and masking in between gives
    what a stop at the first converged iteration gives, and what the JAX
    package's while_loop gives at the same cap and tolerance."""
    from gtsam_personal_tpu.linear import solvers as jsolvers
    lam, tol, cap = 1.0, 1e-6, 250
    d8 = solvers.solve_pcg(case.lin, lam, maxiter=cap, tol=tol)
    monkeypatch.setattr(solvers, "PCG_CHECK_EVERY", 1)
    d1 = solvers.solve_pcg(case.lin, lam, maxiter=cap, tol=tol)
    np.testing.assert_array_equal(d8["se2"].numpy(), d1["se2"].numpy())
    jd = jax.jit(lambda lin: jsolvers.solve_pcg(lin, lam, maxiter=cap,
                                                tol=tol))(case.jlin)
    np.testing.assert_allclose(d8["se2"].numpy(), np.asarray(jd["se2"]),
                               rtol=1e-7, atol=1e-12)


def test_cholesky_of_indefinite_matrix_gives_nan_not_exception(case):
    """JAX's Cholesky returns NaN for a matrix that is not positive definite
    and the LM loop rejects the try; torch's would raise. The port's factor
    is NaN for exactly the bad matrices of a batch, and the solvers pass the
    NaN on."""
    A = torch.eye(3, dtype=torch.float64).repeat(3, 1, 1)
    A[1, 2, 2] = -1.0
    L = solvers.cholesky_nan(A)
    assert torch.isnan(L[1]).all()
    np.testing.assert_array_equal(L[0].numpy(), np.eye(3))
    np.testing.assert_array_equal(L[2].numpy(), np.eye(3))
    jL = np.asarray(jnp.linalg.cholesky(jnp.asarray(A[1].numpy())))
    assert np.isnan(jL[np.tril_indices(3)]).all()
    # lambda = -1e9 makes every front and the dense system indefinite
    for delta in (schur.solve_partitioned(case.lin, case.plan, -1e9),
                  solvers.solve_dense(case.lin, case.layout, -1e9),
                  solvers.solve_pcg(case.lin, -1e9, maxiter=8)):
        assert torch.isnan(delta["se2"]).any()
