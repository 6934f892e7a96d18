"""The port's disjoint-set forest (core/dsf.py) and subgraph-preconditioned
CG (linear/subgraph.py) against the JAX package's, in float64 on the CPU:
tests/test_subgraph_lago.py:17-84, SPCG on a 100-pose Manhattan world
(seed 3) standing in for w100.graph. Its LAGO case is held by
test_torch_initialize.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gtsam_personal_tpu.core import dsf as jdsf
from gtsam_personal_tpu.core.values import Layout as JLayout
from gtsam_personal_tpu.linear import linearize as jlin, subgraph as jsub
from gtsam_personal_tpu.slam import manhattan as jmanhattan
from gtsam_personal_tpu_torch.core.dsf import DSF, generate_tracks, kruskal_mst
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import Layout, Values
from gtsam_personal_tpu_torch.linear import solvers, subgraph
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.slam import factors as F
from test_torch_graph import port_graph, port_values


def test_union_find():
    d = DSF(5)
    d.union(0, 1)
    d.union(3, 4)
    assert d.find(0) == d.find(1)
    assert d.find(0) != d.find(3)
    assert sorted(len(v) for v in d.sets().values()) == [1, 2, 2]
    jd = jdsf.DSF(5)
    jd.union(0, 1)
    jd.union(3, 4)
    assert d.sets() == jd.sets()


def test_track_generation():
    meas = {(0, 0): np.array([1.0, 2.0]), (1, 5): np.array([3.0, 4.0]),
            (2, 7): np.array([5.0, 6.0]), (0, 1): np.array([9.0, 9.0]),
            (1, 6): np.array([8.0, 8.0])}
    matches = [((0, 0), (1, 5)), ((1, 5), (2, 7)), ((0, 1), (1, 6))]
    tracks = generate_tracks(matches, meas)
    assert sorted(len(t) for t in tracks) == [2, 3]
    jtracks = jdsf.generate_tracks(matches, meas)
    assert [[c for c, _ in t] for t in tracks] == \
        [[c for c, _ in t] for t in jtracks]


def test_inconsistent_track_dropped():
    meas = {(0, 0): np.zeros(2), (0, 1): np.zeros(2), (1, 5): np.zeros(2)}
    matches = [((0, 0), (1, 5)), ((0, 1), (1, 5))]      # camera 0 twice
    assert generate_tracks(matches, meas) == []


def test_kruskal():
    edges = [(0, 1), (1, 2), (0, 2), (2, 3)]
    w = [1.0, 2.0, 3.0, 1.0]
    chosen = kruskal_mst(4, edges, w)
    assert len(chosen) == 3
    assert 2 in chosen                  # the heaviest edge first
    assert chosen == jdsf.kruskal_mst(4, edges, w)


def test_spcg_matches_dense():
    jg, jv, _ = jmanhattan.make_manhattan(100, seed=3)
    g, v = port_graph(jg), port_values(jv)
    lin, layout = linearize(g, v), Layout.of(v)
    masks = subgraph.build_spanning_tree_selection(g.batches, v.counts())
    jmasks = jsub.build_spanning_tree_selection(jg.batches, jv.counts())
    for m, jm in zip(masks, jmasks):
        np.testing.assert_array_equal(m, jm)
    d_ref = layout.flatten(solvers.solve_dense(lin, layout, lam=1e-6))
    d_spcg = layout.flatten(subgraph.solve_spcg(lin, masks, layout, lam=1e-6,
                                                maxiter=300, tol=1e-12))
    np.testing.assert_allclose(d_spcg.numpy(), d_ref.numpy(), atol=1e-6)
    jd = jsub.solve_spcg(jax.jit(jlin.linearize)(jg, jv), jmasks,
                         JLayout.of(jv), lam=1e-6, maxiter=300, tol=1e-12)
    np.testing.assert_allclose(d_spcg.numpy(), np.asarray(jd["se2"]).ravel(),
                               rtol=0, atol=1e-9)


def test_spcg_converges_faster_than_jacobi_on_chain():
    """On a pure chain the tree system is the whole system: SPCG is exact
    within 3 iterations, where block-Jacobi PCG is not."""
    b = GraphBuilder()
    F.add_prior(b, "se2", 0, np.zeros(3), F.diag_noise([0.1] * 3))
    n = 120
    for i in range(n - 1):
        F.add_between(b, "se2", i, i + 1, np.array([1.0, 0, 0]),
                      F.diag_noise([0.1] * 3))
    graph = b.build(device="cpu", dtype=torch.float64)
    poses = np.zeros((n, 3))
    poses[:, 0] = np.arange(n) + 0.1
    vals = Values({"se2": torch.tensor(poses)})
    lin, layout = linearize(graph, vals), Layout.of(vals)
    masks = subgraph.build_spanning_tree_selection(graph.batches,
                                                   vals.counts())
    d_ref = layout.flatten(solvers.solve_dense(lin, layout)).numpy()
    d_spcg = layout.flatten(subgraph.solve_spcg(lin, masks, layout,
                                                maxiter=3, tol=1e-12))
    np.testing.assert_allclose(d_spcg.numpy(), d_ref, atol=1e-8)
    d_jac = layout.flatten(solvers.solve_pcg(lin, maxiter=3, tol=1e-12))
    assert np.abs(d_jac.numpy() - d_ref).max() > 1e-3
