"""The port's process groups, dealt factor graphs and camera-dealt BA step
(gtsam_personal_tpu_torch.parallel.{mesh,ba_sharded,bootstrap}) against the
JAX package's sharded paths on the 8-device virtual mesh, in float64 on the
CPU.

The port's ranks run as threads of this process, each with its own gloo
process group over one in-memory store (`run_ranks`): every distributed
function takes its group explicitly, so no process need be spawned. The
other parallel test files use `run_ranks` too."""

import datetime
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from gtsam_personal_tpu.linear import solvers as jsolvers
from gtsam_personal_tpu.linear.linearize import linearize as jlinearize
from gtsam_personal_tpu.parallel import ba_sharded as jba_sharded
from gtsam_personal_tpu.parallel import mesh as jmesh
from gtsam_personal_tpu.sfm import ba as jba, synthetic as jsyn
from gtsam_personal_tpu_torch.linear import linearize as lin_mod, solvers
from gtsam_personal_tpu_torch.parallel import ba_sharded, bootstrap
from gtsam_personal_tpu_torch.parallel import mesh as pmesh
from gtsam_personal_tpu_torch.sfm import ba
from test_torch_graph import port_graph, port_values

F64 = torch.float64
RANK_TIMEOUT = datetime.timedelta(seconds=120)


def run_ranks(n, fn, device="cpu"):
    """fn(mesh) on n ranks, each a thread with a gloo group of its own over
    one store; returns the ranks' results in rank order and raises the
    first rank's exception, if any."""
    store = dist.HashStore()
    out, errors = [None] * n, [None] * n

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("ranks", store), r, n,
                                       RANK_TIMEOUT)
            out[r] = fn(pmesh.make_mesh(pg, device=device))
        except BaseException as e:       # re-raised below, in rank order
            errors[r] = e

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * RANK_TIMEOUT.total_seconds())
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    for e in errors:
        if e is not None:
            raise e
    return out


def _close(got, want, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jmesh.make_mesh(8, axis="dp")


def test_mesh_collectives():
    """psum, sums, psum_tree and barrier on 4 ranks; a world of one and a
    mesh without collectives leave their input as it is."""
    def fn(m):
        t = m.psum(torch.full((3,), float(m.rank + 1), dtype=F64))
        s = m.sums([torch.tensor(1.0, dtype=F64),
                    torch.tensor(float(m.rank), dtype=F64)])
        tree = m.psum_tree({"b": torch.ones(2, 2, dtype=F64),
                            "a": torch.full((1,), float(m.rank))})
        local = m.without_collectives().psum(torch.ones(2))
        m.barrier()
        return t, s, tree, local

    for t, s, tree, local in run_ranks(4, fn):
        _close(t, [10.0] * 3, 0)
        _close(torch.stack(s), [4.0, 6.0], 0)
        _close(tree["b"], np.full((2, 2), 4.0), 0)
        _close(tree["a"], [6.0], 0)
        _close(local, [1.0, 1.0], 0)
    one = pmesh.make_mesh(None, device="cpu")
    assert (one.rank, one.size, one.group) == (0, 1, None)
    _close(one.psum(torch.ones(2)), [1.0, 1.0], 0)
    with pytest.raises(ValueError, match="contiguous"):
        one.psum(torch.ones(2, 2).T)


@pytest.fixture(scope="module")
def pose48():
    from __graft_entry__ import _synthetic_pose_graph
    return _synthetic_pose_graph(n_poses=48, dtype=np.float64)


@pytest.fixture(scope="module")
def jax_pose48(pose48, mesh8):
    """The JAX test's step, single-device and on the sharded graph."""
    graph, initial = pose48

    @jax.jit
    def step(graph, values, lam):
        lin = jlinearize(graph, values)
        delta = jsolvers.solve_pcg(lin, lam, maxiter=100, tol=1e-10)
        nv = values.retract(delta)
        return nv, graph.error(nv)

    lam = jnp.asarray(1e-4)
    single = step(graph, initial, lam)
    sharded = step(jmesh.shard_graph(graph, mesh8, axis="dp"),
                   jmesh.replicate_values(initial, mesh8), lam)
    return single, sharded


def test_sharded_pose_graph_matches_single(pose48, jax_pose48):
    """One LM step of the 48-pose graph dealt over 8 ranks: the JAX sharded
    step and the port's single-device step, to 1e-10."""
    jgraph, jinit = pose48
    graph, init = port_graph(jgraph), port_values(jinit)
    (_, je_single), (jv_shard, je_shard) = jax_pose48

    def fn(m):
        return pmesh.sharded_step(pmesh.shard_graph(graph, m),
                                  pmesh.replicate_values(init, m), 1e-4, m,
                                  maxiter=100, tol=1e-10)

    v1, e1 = pmesh.sharded_step(graph, init, 1e-4,
                                pmesh.make_mesh(None, device="cpu"),
                                maxiter=100, tol=1e-10)
    lin = lin_mod.linearize(graph, init)
    v0 = init.retract(solvers.solve_pcg(lin, 1e-4, maxiter=100, tol=1e-10))
    _close(v1["se2"], v0["se2"], 0)              # world of one: no sum
    for v, e in run_ranks(8, fn):
        np.testing.assert_allclose(float(e), float(je_shard), rtol=1e-10)
        np.testing.assert_allclose(float(e), float(e1), rtol=1e-10)
        _close(v["se2"], jv_shard["se2"], 1e-10)
        _close(v["se2"], v1["se2"], 1e-10)
    np.testing.assert_allclose(float(je_shard), float(je_single), rtol=1e-10)


def test_shard_graph_deals_every_factor(pose48):
    """Each batch is padded to a multiple of the world size with
    zero-information copies of factor 0 and dealt in contiguous blocks:
    the shards' factors are the graph's, and their errors sum to its."""
    jgraph, jinit = pose48
    graph, init = port_graph(jgraph), port_values(jinit)
    n = 5

    def fn(m):
        sh = pmesh.shard_graph(graph, m)
        return ([(b.idx, b.noise.data) for b in sh.batches],
                float(sh.error(init)), float(pmesh.sharded_error(sh, init, m)))

    out = run_ranks(n, fn)
    for k, b in enumerate(graph.batches):
        idx = torch.cat([o[0][k][0] for o in out])
        data = torch.cat([o[0][k][1] for o in out])
        K = b.size
        assert idx.shape[0] == K + (-K) % n
        assert torch.equal(idx[:K], b.idx)
        assert torch.equal(idx[K:], b.idx[:1].expand(idx.shape[0] - K, -1))
        assert float(data[K:].abs().sum()) == 0.0
    total = float(graph.error(init))
    np.testing.assert_allclose(sum(o[1] for o in out), total, rtol=1e-12)
    for o in out:
        np.testing.assert_allclose(o[2], total, rtol=1e-12)


def test_sharded_ba_matches_single(mesh8):
    """The 16-camera ring's try step dealt over 8 ranks by camera: the
    port's single-device ba_try_step to 1e-8 (the JAX test's tolerance,
    sharded against single), and the JAX GSPMD step to 1e-5: both stop CG
    at its fixed 1e-6 tolerance, where two implementations' iterates differ
    by rounding amplified by the system's condition (ROADMAP queue 3 A7;
    tests/test_torch_ba_cm.py::test_ba_try_step holds the single-device
    pair to the same 1e-5)."""
    prob = jsyn.make_ring_problem(num_cameras=16, num_points=64,
                                  obs_per_point=4, seed=5)
    jstate, jobs = jba.state_from_bal(prob)
    jlayout = jba.make_layout(jobs, 16, 64)
    lam = jnp.asarray(1e-4, dtype=jstate.points.dtype)
    st, ob, ly = jba_sharded.shard_ba(jstate, jobs, jlayout, mesh8)
    js, je = jax.jit(lambda s, o, l: jba_sharded.sharded_ba_step(
        s, o, l, lam, cg_maxiter=50))(st, ob, ly)

    state, obs = ba.state_from_bal(prob, device="cpu", dtype=F64)
    layout = ba.make_layout(obs, 16, 64)
    s1, e1 = ba.ba_try_step(state, obs, layout, 1e-4, cg_maxiter=50)

    def fn(m):
        s, o, dl = ba_sharded.shard_ba(state, obs, layout, m)
        return ba_sharded.sharded_ba_step(s, o, dl, 1e-4, cg_maxiter=50)

    for s2, e2 in run_ranks(8, fn):
        np.testing.assert_allclose(float(e2), float(e1), rtol=1e-8)
        _close(s2.points, s1.points, 1e-8)
        _close(s2.cam_poses, s1.cam_poses, 1e-8)
        np.testing.assert_allclose(float(e2), float(je), rtol=1e-5)
        _close(s2.points, js.points,
               1e-5 * np.abs(np.asarray(js.points)).max())


def test_dryrun_counterpart():
    """The port's counterpart of the JAX multi-chip dryrun
    (__graft_entry__.dryrun_multichip(8)): the 32-pose float32 graph's
    sharded step and the 16-camera ring's sharded BA try step on 8 ranks,
    finite and the same on every rank."""
    from __graft_entry__ import _synthetic_pose_graph
    jgraph, jinit = _synthetic_pose_graph(n_poses=32)
    graph = port_graph(jgraph, dtype=torch.float32)
    init = port_values(jinit, dtype=torch.float32)
    prob = jsyn.make_ring_problem(num_cameras=16, num_points=64,
                                  obs_per_point=4, seed=7)
    state, obs = ba.state_from_bal(prob, device="cpu", dtype=torch.float32)
    layout = ba.make_layout(obs, 16, 64)

    def fn(m):
        _, e = pmesh.sharded_step(pmesh.shard_graph(graph, m), init, 1e-4, m,
                                  maxiter=25, tol=1e-6)
        s, o, dl = ba_sharded.shard_ba(state, obs, layout, m)
        return float(e), float(ba_sharded.sharded_ba_step(s, o, dl, 1e-4)[1])

    out = run_ranks(8, fn)
    assert all(np.isfinite(out[0])) and all(o == out[0] for o in out)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_bootstrap_noop_and_validation(monkeypatch):
    """Flag off: a no-op. Enabled without a coordinator, or without the
    process count and rank (torch cannot infer them): ValueError. Enabled
    with all three: the default group (gloo here) joins, process_info
    reports it and make_mesh takes it."""
    for var in ("GTSAM_TPU_DIST", "GTSAM_TPU_COORD", "GTSAM_TPU_NPROCS",
                "GTSAM_TPU_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert bootstrap.maybe_init_distributed() is False
    assert bootstrap.process_info() == (0, 1, torch.cuda.device_count(), 1)
    monkeypatch.setenv("GTSAM_TPU_DIST", "1")
    with pytest.raises(ValueError, match="coordinator"):
        bootstrap.maybe_init_distributed()
    monkeypatch.setenv("GTSAM_TPU_COORD", f"localhost:{_free_port()}")
    with pytest.raises(ValueError, match="GTSAM_TPU_NPROCS"):
        bootstrap.maybe_init_distributed()
    monkeypatch.setenv("GTSAM_TPU_NPROCS", "1")
    monkeypatch.setenv("GTSAM_TPU_PROC_ID", "0")
    assert not dist.is_initialized()
    try:
        assert bootstrap.maybe_init_distributed() is True
        assert dist.get_backend() == "gloo"
        assert bootstrap.process_info() == (0, 1, 0, 1)
        m = pmesh.make_mesh(device="cpu")
        assert m.group is dist.group.WORLD and (m.rank, m.size) == (0, 1)
        _close(m.psum(torch.ones(3)), [1.0] * 3, 0)
    finally:
        dist.destroy_process_group()


def test_make_mesh_defaults_to_the_card():
    """Without device=..., a mesh is on the card; without a card that
    raises instead of running on the CPU unawares."""
    if torch.cuda.is_available():
        assert pmesh.make_mesh(None).device == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            pmesh.make_mesh(None)
