"""The port's marginalization (gtsam_personal_tpu_torch/linear/marginal.py)
against the JAX package, float64 on the CPU, on one graph built with the JAX
GraphBuilder and carried across as numpy arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core import graph as jgraph_mod, values as jvalues_mod
from gtsam_personal_tpu.linear import marginal as jmarg
from gtsam_personal_tpu.slam import factors as JF
from gtsam_personal_tpu_torch.core import graph as graph_mod, values as values_mod
from gtsam_personal_tpu_torch.core.graph import FactorGraph
from gtsam_personal_tpu_torch.linear import marginal as marg
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.linear.solvers import solve_dense
from gtsam_personal_tpu_torch.slam import factors as F

F64 = torch.float64


def _np(x):
    return None if x is None else np.asarray(x)


class Case:
    """A 12-pose SE(2) chain with two closures, a pose_point_2d landmark
    batch and a full-information closure, in both packages."""

    def __init__(self):
        rng = np.random.default_rng(4)
        n = 12
        jb = jgraph_mod.GraphBuilder()
        poses = np.stack([[0.8 * k, 0.1 * np.sin(k), 0.05 * k]
                          for k in range(n)])
        JF.add_prior(jb, "se2", 0, poses[0], JF.diag_noise([0.1, 0.1, 0.05]))
        rel = lambda i, j: np.asarray(JF.se2.between(
            jnp.asarray(poses[i]), jnp.asarray(poses[j])))
        for k in range(n - 1):
            JF.add_between(jb, "se2", k, k + 1,
                           rel(k, k + 1) + rng.normal(0, 0.02, 3),
                           JF.diag_noise([0.05, 0.05, 0.01]))
        JF.add_between(jb, "se2", 1, 7, rel(1, 7), JF.diag_noise([0.1] * 3))
        A = rng.normal(size=(3, 3))
        jb.add("between_se2", JF.make_between_residual("se2"),
               ("se2", "se2"), 3, [2, 9], {"measured": rel(2, 9)},
               JF.full_info_noise(A @ A.T + 3 * np.eye(3)))
        lmk = np.array([[2.0, 1.5], [5.0, -1.0]])
        for k, li in ((1, 0), (2, 0), (3, 0), (5, 1), (6, 1)):
            d = lmk[li] - poses[k][:2]
            c, s = np.cos(poses[k][2]), np.sin(poses[k][2])
            jb.add("pose_point_2d", JF.pose_point_2d_residual,
                   ("se2", "point2"), 2, [k, li],
                   {"measured": np.array([c * d[0] + s * d[1],
                                          c * d[1] - s * d[0]])
                    + rng.normal(0, 0.05, 2)},
                   {"kind": "diag", "data": np.array([10.0, 10.0])})
        self.jgraph = jb.build(dtype=np.float64)
        init = {"se2": poses + rng.normal(0, 0.03, poses.shape),
                "point2": lmk + rng.normal(0, 0.1, lmk.shape)}
        self.jvalues = jvalues_mod.Values(
            {g: jnp.asarray(a) for g, a in init.items()})
        self.graph = graph_mod.graph_from_numpy(
            [{"name": b.name, "groups": b.groups, "rdim": b.rdim,
              "idx": _np(b.idx),
              "meas": {k: _np(v) for k, v in b.meas.items()},
              "noise": {"kind": b.noise.kind, "data": _np(b.noise.data),
                        "robust": b.noise.robust, "k": _np(b.noise.k)}}
             for b in self.jgraph.batches],
            F.residual_by_name, device="cpu", dtype=F64)
        self.values = values_mod.values_from_numpy(init, device="cpu",
                                                   dtype=F64)


@pytest.fixture(scope="module")
def case():
    return Case()


MARG = [{"se2": [0, 1]}, {"se2": [3], "point2": [0]}, {"se2": [6, 7]}]


@pytest.mark.parametrize("marg_set", MARG, ids=["head", "pose+landmark",
                                                "middle"])
def test_marginalize_matches_jax(case, marg_set):
    jrest, jm, jbound = jmarg.marginalize(case.jgraph, case.jvalues, marg_set)
    rest, m, bound = marg.marginalize(case.graph, case.values, marg_set)
    assert bound == jbound and m.groups == jm.groups and m.rdim == jm.rdim
    assert m.name == jm.name and m.noise.kind == "unit"
    np.testing.assert_array_equal(m.idx.numpy(), np.asarray(jm.idx))
    assert sorted(m.meas) == sorted(jm.meas)
    # the square root of the marginal information is fixed up to the signs
    # of an eigendecomposition's vectors: compare S^T S and S^T r0
    S, jS = m.meas["sqrt_info"][0].numpy(), np.asarray(jm.meas["sqrt_info"][0])
    r0, jr0 = m.meas["r0"][0].numpy(), np.asarray(jm.meas["r0"][0])
    scale = np.abs(jS.T @ jS).max()
    np.testing.assert_allclose(S.T @ S, jS.T @ jS, rtol=1e-9,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(S.T @ r0, jS.T @ jr0, rtol=1e-9,
                               atol=1e-9 * np.abs(jS.T @ jr0).max())
    for s in range(len(bound)):
        np.testing.assert_array_equal(m.meas[f"anchor{s}"].numpy(),
                                      np.asarray(jm.meas[f"anchor{s}"]))
    # what stays: the same factors in the same batches
    assert [b.name for b in rest.batches] == [b.name for b in jrest.batches]
    for b, jb in zip(rest.batches, jrest.batches):
        np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
    # and the marginal factor's error and residual at the linearization point
    np.testing.assert_allclose(
        float(FactorGraph([m]).error(case.values)),
        float(jgraph_mod.FactorGraph([jm]).error(case.jvalues)), rtol=1e-8)


def test_marginal_factor_reproduces_the_schur_complement(case):
    """Solving the reduced graph plus the marginal factor gives the step of
    the full graph on the variables that stay (the marginal is exact at the
    linearization point)."""
    rest, m, _ = marg.marginalize(case.graph, case.values, {"se2": [0, 1]})
    full = solve_dense(linearize(case.graph, case.values),
                       values_mod.Layout.of(case.values), 0.0)
    reduced = solve_dense(
        linearize(FactorGraph(rest.batches + [m]), case.values),
        values_mod.Layout.of(case.values), 1.0e-9)   # slots 0, 1 are free
    np.testing.assert_allclose(reduced["se2"][2:].numpy(),
                               full["se2"][2:].numpy(), atol=1e-6)
    np.testing.assert_allclose(reduced["point2"].numpy(),
                               full["point2"].numpy(), atol=1e-6)


def test_marginalize_untouched_and_disconnected(case):
    rest, m, bound = marg.marginalize(case.graph, case.values, {"point2": []})
    assert m is None and bound == [] and len(rest.batches) == len(
        case.graph.batches)
    lone = FactorGraph([case.graph.batches[0]])       # the prior on pose 0
    rest, m, bound = marg.marginalize(lone, case.values, {"se2": [0]})
    assert m is None and bound == [] and rest.batches == []


@pytest.mark.parametrize("boundary", [
    [("se2", 4), ("se2", 5)],
    [("point2", 1), ("se2", 0), ("se2", 11)],
    [("se2", k) for k in range(12)] + [("point2", 0), ("point2", 1)],
], ids=["two-poses", "landmark-and-ends", "everything"])
def test_graph_info_on_matches_jax(case, boundary):
    jL, jg = jmarg.graph_info_on(case.jgraph, case.jvalues, boundary)
    L, g = marg.graph_info_on(case.graph, case.values, boundary)
    assert L.shape == jL.shape and g.shape == jg.shape
    np.testing.assert_allclose(L, jL, rtol=1e-9, atol=1e-9 * np.abs(jL).max())
    np.testing.assert_allclose(g, jg, rtol=1e-9, atol=1e-9 * np.abs(jg).max())


def test_graph_info_on_untouched_slot_is_zero(case):
    sub = FactorGraph([case.graph.batches[0]])
    L, g = marg.graph_info_on(sub, case.values, [("se2", 0), ("se2", 9)])
    assert L.shape == (6, 6) and not L[3:].any() and not L[:, 3:].any()
    assert L[:3, :3].any() and not g[3:].any()


def test_select_keeps_shared_noise(case):
    b = case.graph.batches[1]
    rows = np.array([0, 3, 4])
    sub = marg._select(b, rows)
    assert sub.size == 3 and sub.noise.kind == b.noise.kind
    np.testing.assert_array_equal(sub.idx.numpy(), b.idx.numpy()[rows])
    np.testing.assert_array_equal(sub.noise.data.numpy(),
                                  b.noise.data.numpy()[rows])
    shared = graph_mod.FactorBatch(
        b.name, b.residual_fn, b.groups, b.rdim, b.idx, b.meas,
        marg.NoiseModel("diag", torch.tensor([20.0, 20.0, 100.0], dtype=F64)))
    assert marg._select(shared, rows).noise.data is shared.noise.data
