"""The port's ISAM2 against the JAX engine, second part: the eviction stream
(marginalize_variables with recycled slots), and pieces of the port's
engine by themselves: the padded relinearization bucket, clone, the PCG
count, the cached-preconditioner rule, the trust region, float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.graph import GraphBuilder as JGraphBuilder
from gtsam_personal_tpu.core.values import Values as JValues
from gtsam_personal_tpu.nonlinear import isam2 as jisam
from gtsam_personal_tpu.nonlinear import optimizers as joptimizers
from gtsam_personal_tpu.slam import factors as jF
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear import noise as tnz
from gtsam_personal_tpu_torch.linear import solvers
from gtsam_personal_tpu_torch.linear.linearize import linearize_batch
from gtsam_personal_tpu_torch.nonlinear import isam2 as tisam
from gtsam_personal_tpu_torch.slam import factors as F

from test_torch_isam2 import (F64, PRIOR_SIGMAS, SIGMAS, Pair, _between,
                              _compose, _make_manhattan)


@pytest.fixture(scope="module")
def eviction():
    """A 72-pose odometry stream with a 10-pose lag window: every pose past
    the window is marginalized out, in both engines. 72 poses need more than
    the 64 slots, so slots are recycled."""
    rng = np.random.default_rng(11)
    n, lag = 72, 10
    gt = [np.zeros(3)]
    for k in range(1, n):
        gt.append(_compose(gt[-1], np.array([1.0, 0.0, 0.02])))
    meas = [_between(gt[k - 1], gt[k]) + rng.normal(0, [0.03, 0.03, 0.005])
            for k in range(1, n)]
    pair = Pair(relinearize_threshold=0.01, cg_maxiter=40, cg_tol=1e-8,
                relin_chunk=64)
    slot_of = {0: pair.add_variable("se2", np.zeros(3))}
    pair.prior_se2(0, np.zeros(3))
    pair.update()
    live = [0]
    for k in range(1, n):
        prev = pair.j.estimate_at("se2", slot_of[k - 1])
        slot_of[k] = pair.add_variable("se2", _compose(prev, meas[k - 1]))
        pair.between_se2(slot_of[k - 1], slot_of[k], meas[k - 1])
        pair.update()
        live.append(k)
        if len(live) > lag + 1:
            old = live.pop(0)
            pair.j.marginalize_variables({"se2": [slot_of[old]]})
            pair.t.marginalize_variables({"se2": [slot_of[old]]})
            pair.update()
    return pair, slot_of, live, np.stack(gt), meas


def test_eviction_keeps_capacity_bounded(eviction):
    pair = eviction[0]
    assert pair.t._cap_n["se2"] == 64 == pair.j._cap_n["se2"]
    for key, h in pair.t._hosts.items():
        assert h["cap"] <= 64, (key, h["cap"])
    assert pair.t._state.theta["se2"].shape[0] == 64


def test_eviction_matches_the_jax_engine(eviction):
    pair, slot_of, live = eviction[:3]
    assert all(rj.relinearized_rows == rt.relinearized_rows
               and abs(rj.cg_iterations - rt.cg_iterations) <= 1
               for rj, rt, _ in pair.stats)
    got = np.stack([pair.t.estimate_at("se2", slot_of[k]) for k in live])
    want = np.stack([pair.j.estimate_at("se2", slot_of[k]) for k in live])
    # the marginal's sqrt-information goes through an eigendecomposition on
    # the host in both packages, and its rounding enters every later update
    np.testing.assert_allclose(got, want, atol=1e-7)
    np.testing.assert_allclose(pair.t.error(), pair.j.error(), rtol=1e-6,
                               atol=1e-12)


def test_eviction_window_matches_the_batch_solve(eviction):
    pair, slot_of, live, gt, meas = eviction
    gb = JGraphBuilder()
    gb.add("prior_se2", jF.make_prior_residual("se2"), ["se2"], 3, [0],
           {"prior": np.zeros(3)}, {"kind": "diag",
                                    "data": 1.0 / PRIOR_SIGMAS})
    for k in range(1, len(gt)):
        gb.add("between_se2", jF.make_between_residual("se2"),
               ["se2", "se2"], 3, [k - 1, k], {"measured": meas[k - 1]},
               {"kind": "diag", "data": 1.0 / SIGMAS})
    batch = joptimizers.optimize_lm(
        gb.build(), JValues({"se2": jnp.asarray(gt)}),
        joptimizers.Params(max_iterations=30))
    best = np.asarray(batch.values["se2"])
    got = np.stack([pair.t.estimate_at("se2", slot_of[k]) for k in live])
    np.testing.assert_allclose(got[:, :2], best[np.asarray(live), :2],
                               atol=2e-3)


# --- pieces of the port's engine --------------------------------------------

def _small_engine(n=12, **params):
    """A port engine after an n-pose odometry stream with one closure."""
    gt, edges = _make_manhattan(n, closure_every=1000)
    isam = tisam.ISAM2(tisam.ISAM2Params(dtype=params.pop("dtype", F64),
                                         **params), device="cpu")
    pn = tnz.NoiseModel("diag", 1.0 / PRIOR_SIGMAS)
    bn = tnz.NoiseModel("diag", 1.0 / SIGMAS)
    rb = F.make_between_residual("se2")
    isam.add_variable("se2", np.zeros(3))
    isam.add_factor("prior_se2", F.make_prior_residual("se2"), ["se2"], 3,
                    [0], {"prior": np.zeros(3)}, pn)
    pose = np.zeros(3)
    for i, j, m in edges:
        pose = _compose(pose, m)
        isam.add_variable("se2", pose)
        isam.add_factor("between_se2", rb, ["se2", "se2"], 3, [i, j],
                        {"measured": m}, bn)
        isam.update()
    isam.add_factor("between_se2", rb, ["se2", "se2"], 3, [0, n - 1],
                    {"measured": _between(gt[0], gt[n - 1])}, bn)
    isam.update()
    return isam


def test_padded_relinearization_bucket_writes_only_live_rows():
    """11 stale rows in a bucket of 16: the padding (copies of row 0) is
    linearized and dropped; rows that are not stale keep their cached blocks
    bit for bit, stale rows get a fresh linearization, and rows past nfac
    stay zero."""
    isam = _small_engine(n=30, relinearize_threshold=1e9, relin_chunk=8)
    st = isam._state
    b = st.batches[1]
    assert b.name == "between_se2" and b.nfac == 30 and b.cap == 64
    stale_rows = torch.tensor([1, 2, 3, 5, 8, 13, 14, 20, 21, 27, 29])
    # move theta, so that a fresh linearization differs from the cache
    theta = {"se2": st.theta["se2"] + 0.01}
    moved = tisam._State(theta, st.delta, st.nvar, [
        st.batches[0],
        b.replace(needs_lin=torch.zeros(64, dtype=torch.bool).index_fill(
            0, stale_rows, True))])
    new, n_relin, _, _ = tisam._isam2_update(
        moved, 1e9, 1e-6, 5, 1e-6, 1e-10, 8)
    assert n_relin == 11
    nb = new.batches[1]
    keep = torch.ones(64, dtype=torch.bool).index_fill(0, stale_rows, False)
    assert torch.equal(nb.r[keep], b.r[keep])
    assert all(torch.equal(a[keep], c[keep]) for a, c in zip(nb.J, b.J))
    fresh = linearize_batch(b.rows(stale_rows), Values(theta))
    assert torch.equal(nb.r[stale_rows], fresh.r)
    assert all(torch.equal(a[stale_rows], c) for a, c in zip(nb.J, fresh.Js))
    assert not torch.equal(nb.r[stale_rows], b.r[stale_rows])
    assert not nb.r[30:].any() and not nb.J[0][30:].any()
    assert not nb.needs_lin.any()
    # the state that went in is untouched
    assert moved.batches[1].needs_lin.sum() == 11


def test_clone_forks_the_engine():
    isam = _small_engine()
    fork = isam.clone()
    before = isam.estimate_array("se2").copy()
    err = isam.error()
    i = fork.add_variable("se2", _compose(before[-1], [1.0, 0.0, 0.0]))
    fork.add_factor("between_se2", F.make_between_residual("se2"),
                    ["se2", "se2"], 3, [i - 1, i],
                    {"measured": np.array([1.0, 0.3, 0.1])},
                    tnz.NoiseModel("diag", 1.0 / SIGMAS))
    fork.add_factor("between_se2", F.make_between_residual("se2"),
                    ["se2", "se2"], 3, [2, i],
                    {"measured": np.array([0.5, 0.3, 0.1])},
                    tnz.NoiseModel("diag", 1.0 / SIGMAS))
    for _ in range(3):
        fork.update()
    assert fork.estimate_array("se2").shape[0] == before.shape[0] + 1
    assert np.abs(fork.estimate_array("se2")[:-1] - before).max() > 1e-6
    np.testing.assert_array_equal(isam.estimate_array("se2"), before)
    assert isam.error() == err
    assert isam._nvar["se2"] == before.shape[0]
    # and the original goes on by itself
    isam.update()
    assert isam.estimate_array("se2").shape == before.shape


def test_pcg_count_is_that_of_an_exact_stop(monkeypatch):
    """Reading the stop flag every 8 iterations and masking in between
    gives the iterate and the count of a check every iteration, and the
    count of the JAX package's while_loop on the same system."""
    rng = np.random.default_rng(2)
    n, d = 40, 3
    Q = rng.normal(size=(n * d, n * d))
    A = Q @ Q.T / (n * d) + 0.5 * np.eye(n * d)
    bvec, x0 = rng.normal(size=(n, d)), 0.1 * rng.normal(size=(n, d))
    At = torch.tensor(A)

    def run(tol):
        return tisam._pcg_counting(
            lambda x: {"v": (At @ x["v"].reshape(-1)).reshape(n, d)},
            {"v": torch.tensor(bvec)}, lambda r: r, {"v": torch.tensor(x0)},
            60, tol, 0.0)

    for tol in (1e-2, 1e-5, 1e-30):
        monkeypatch.setattr(solvers, "PCG_CHECK_EVERY", 8)
        x8, k8 = run(tol)
        monkeypatch.setattr(solvers, "PCG_CHECK_EVERY", 1)
        x1, k1 = run(tol)
        assert k8 == k1 and torch.equal(x8["v"], x1["v"])
        Aj = jnp.asarray(A)
        xj, kj = jisam._pcg_counting(
            lambda x: {"v": (Aj @ x["v"].reshape(-1)).reshape(n, d)},
            {"v": jnp.asarray(bvec)}, lambda r: r, {"v": jnp.asarray(x0)},
            60, tol, 0.0)
        assert k8 == int(kj)
        np.testing.assert_allclose(x8["v"].numpy(), np.asarray(xj["v"]),
                                   rtol=1e-9, atol=1e-12)
    assert k8 == 60                       # tol 1e-30: the cap ends it


def test_preconditioner_cache_rule(monkeypatch):
    """Rebuilt when a variable was added or after precond_refresh updates,
    reused otherwise; a capacity change drops it."""
    builds = []
    real = tisam._build_precond_cache
    monkeypatch.setattr(tisam, "_build_precond_cache",
                        lambda *a: builds.append(1) or real(*a))
    isam = _small_engine(n=8, precond="chain:se2", precond_refresh=3)
    # 7 updates that each added a pose; the closure's update reused the cache
    assert len(builds) == 7
    builds.clear()
    for _ in range(8):
        isam.update()
    # one more reuse, then rebuild, 2 reuses, rebuild, 2 reuses, rebuild
    assert len(builds) == 3
    cache = isam._pcache
    isam.add_factor("between_se2", F.make_between_residual("se2"),
                    ["se2", "se2"], 3, [1, 5],
                    {"measured": np.array([4.0, 0.0, 0.0])},
                    tnz.NoiseModel("diag", 1.0 / SIGMAS))
    isam.update()                    # a factor alone keeps the cache
    assert isam._pcache is cache
    for k in range(8, 66):           # past 64 slots: capacity doubles
        isam.add_variable("se2", np.array([float(k), 0.0, 0.0]))
    isam.update()
    assert isam._pcache["Uinv"].shape[0] == 128


def test_max_delta_clips_each_variable():
    isam = _small_engine(max_delta=1e-3, relinearize_threshold=1e9)
    nrm = isam._state.delta["se2"].norm(dim=1)
    assert nrm.max() <= 1e-3 * (1 + 1e-12) and nrm.max() > 0.5e-3


def test_float32_engine_tracks_float64():
    """The tangents of the float32 engine stay float32 (the 0-dim trap of
    vmap(jacfwd)), and its estimate follows the float64 one."""
    e32 = _small_engine(n=20, dtype=torch.float32, precond="chain:se2")
    e64 = _small_engine(n=20, precond="chain:se2")
    st = e32._state
    assert all(t.dtype == torch.float32 for t in (
        st.theta["se2"], st.delta["se2"], st.batches[1].r,
        *st.batches[1].J, e32._pcache["Uinv"]))
    np.testing.assert_allclose(e32.estimate_array("se2"),
                               e64.estimate_array("se2"), atol=2e-3)


# --- the stream runner ------------------------------------------------------

def test_stream_runner_orders_factors_and_reaches_the_batch_optimum():
    """tools/profile_isam2.py on a 120-pose Manhattan world: factors come
    ordered by their later pose, odometry before closures; updates come
    every 5 measurements up to pose 80 and after every measurement from
    there; the streamed error ends at the batch optimum."""
    from gtsam_personal_tpu_torch.nonlinear import optimizers
    from gtsam_personal_tpu_torch.slam import manhattan
    from gtsam_personal_tpu_torch.tools import profile_isam2 as drv
    n = 120
    graph, initial, _ = manhattan.make_manhattan(n, seed=42, device="cpu",
                                                 dtype=F64)
    data = drv.stream_data(graph)
    ij = data["ij"]
    later = ij.max(axis=1)
    assert (np.diff(later) >= 0).all() and len(ij) == graph.num_factors - 1
    first = {}
    for k, (i, j) in enumerate(ij):
        first.setdefault(max(i, j), (k, j - i))
    assert all(span == 1 for _, span in first.values())   # odometry first
    assert sorted(map(tuple, ij)) == sorted(
        map(tuple, graph.batches[1].idx.numpy()))
    isam = drv.make_engine(data, device="cpu", dtype=F64, cg_maxiter=200,
                           cg_tol=1e-8)
    assert isam._cap_n["se2"] == 128 and isam.params.precond == "chain:se2"
    recs = drv.run_stream(isam, data, update_every=5, switch_pose=80)
    tail = [r for r in recs if r[0] >= 80]
    assert len(tail) == int((later >= 79).sum())   # one per measurement
    assert len(recs) < len(ij) and recs[-1][0] == n
    drv.polish(isam, 3)
    err0 = optimizers.graph_error(graph, initial)
    _, _, best = optimizers.lm_run(graph, initial, 1e-5, err0, 12,
                                   optimizers.Params(solver="dense"))
    assert isam.error() <= 1.001 * float(best)
    k, ms, rmed, rmax, cmed, cmax = drv.summarize(recs)
    assert k == len(recs) and ms > 0 and rmax >= rmed and cmax <= 200
