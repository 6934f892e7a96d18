"""The port's slam/initialize.py and tools/pose_graph_g2o.py against the JAX
package, float64 on the CPU.

Graphs: the 12-pose noise-free SE(3) chain with one closure of
tests/test_pose3slam.py:22, a 60-pose noisy SE(3) graph with closures, and
make_manhattan(200) for the 2D initialization; both packages get the same
numpy arrays. Tolerances: rtol 1e-9 with an atol of 1e-9 times the largest
entry (1e-7 in the PCG branch, which stops at a tolerance of 1e-10 of the
gradient, not at the solution)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core.graph import GraphBuilder as JGraphBuilder
from gtsam_personal_tpu.linear import schur as jschur
from gtsam_personal_tpu.nonlinear import optimizers as joptimizers
from gtsam_personal_tpu.slam import dataset as jds, initialize as jinit
from gtsam_personal_tpu.slam import factors as JF, manhattan as jmanhattan
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.geometry import se3
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam import dataset as ds, initialize
from gtsam_personal_tpu_torch.slam import factors as F, manhattan
from gtsam_personal_tpu_torch.tools import pose_graph_g2o

F64 = torch.float64


def close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _se3_graph(n, seed, noise, closures):
    """A prior on pose 0 at the identity, odometry and the closures (i, j)
    from poses composed of random steps; measurements retracted by `noise`.
    Returns (JAX graph, port graph, truth)."""
    rng = np.random.default_rng(seed)
    steps = se3.expmap(torch.tensor(rng.normal(scale=0.4, size=(n - 1, 6))))
    truth = [torch.eye(3, 4, dtype=F64)]
    for k in range(n - 1):
        truth.append(se3.compose(truth[-1], steps[k]))
    truth = torch.stack(truth)
    jb, tb = JGraphBuilder(), GraphBuilder()
    for b, mod in ((jb, JF), (tb, F)):
        mod.add_prior(b, "se3", 0, truth[0].numpy(), F.diag_noise([0.1] * 6))
    pairs = [(i, i + 1) for i in range(n - 1)] + closures
    for i, j in pairs:
        rel = se3.between(truth[i], truth[j])
        if noise:
            rel = se3.retract(rel, torch.tensor(
                rng.normal(scale=noise, size=6)))
        for b, mod in ((jb, JF), (tb, F)):
            mod.add_between(b, "se3", i, j, rel.numpy(),
                            F.diag_noise([0.05] * 6))
    return (jb.build(dtype=jnp.float64), tb.build(device="cpu", dtype=F64),
            truth)


GRAPHS = {"pose3slam_12": lambda: _se3_graph(12, 3, 0.0, [(0, 11)]),
          "noisy_60": lambda: _se3_graph(
              60, 7, 0.02, [(i, i + 9) for i in range(0, 50, 4)])}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("branch", ["dense", "pcg"])
def test_chordal_init(graph, branch):
    jg, tg, _ = GRAPHS[graph]()
    n = 12 if graph == "pose3slam_12" else 60
    use_pcg = branch == "pcg"
    # one compiled program: the JAX package's op-by-op dispatch of the same
    # steps compiles each primitive on first use, five times slower here
    ref = jax.jit(lambda: jinit.chordal_init(jg, n, use_pcg=use_pcg)
                  .blocks)()["se3"]
    got = initialize.chordal_init(tg, n, use_pcg=use_pcg)["se3"]
    close(got.numpy(), ref, 1e-7 if use_pcg else 1e-9)
    # the host path: the same sparse system, float64
    ref64 = jinit.chordal_init_f64(jg, n)["se3"]
    got64 = initialize.chordal_init_f64(tg, n, device="cpu", dtype=F64)
    close(got64["se3"].numpy(), ref64, 1e-9)
    if graph == "pose3slam_12":      # noise-free: the chordal point is exact
        assert float(optimizers.graph_error(tg, got64)) < 1e-6


def test_lago_init_2d():
    jg, _, _ = jmanhattan.make_manhattan(200, seed=3)
    tg, _, _ = manhattan.make_manhattan(200, seed=3, device="cpu", dtype=F64)
    ref = jinit.lago_init_2d(jg, 200)["se2"]
    got = initialize.lago_init_2d(tg, 200)
    close(got["se2"].numpy(), ref, 1e-9)
    assert got["se2"].dtype == F64


def test_lago_and_chordal_follow_the_graph_dtype():
    tg, _, _ = manhattan.make_manhattan(50, seed=3, device="cpu",
                                        dtype=torch.float32)
    assert initialize.lago_init_2d(tg, 50)["se2"].dtype == torch.float32
    _, tg3, _ = GRAPHS["pose3slam_12"]()
    v = initialize.chordal_init_f64(tg3, 12, device="cpu",
                                    dtype=torch.float32)
    assert v["se3"].dtype == torch.float32


def test_cli_matches_jax_example(tmp_path):
    """The tool's 3D path on a 60-pose file the test writes: the same
    steps as examples/pose_graph_g2o.py through the JAX package end at its
    error; --out writes a file that load_3d reads back at that error."""
    _, tg, truth = GRAPHS["noisy_60"]()
    rng = np.random.default_rng(8)
    start = se3.retract(truth, torch.tensor(
        rng.normal(scale=0.05, size=(60, 6))))
    path = str(tmp_path / "noisy60.g2o")
    ds.write_g2o_3d(path, optimizers.Values({"se3": start}), tg, fmt="quat")
    out = str(tmp_path / "out.g2o")
    lines = []
    rec = pose_graph_g2o.run(path, three_d=True, out=out, device="cpu",
                             say=lines.append)
    pose_graph_g2o.main([path, "--3d", "--device", "cpu", "--max-part",
                         "16"])

    jg, jv = jds.load_3d(path, dtype=np.float64)
    jv = jinit.chordal_init_f64(jg, 60)
    plan = jschur.make_plan(jg, jv.counts(), max_part_size=128)
    jres = joptimizers.optimize_lm(
        jg, jv, joptimizers.Params(solver="schur", max_iterations=30),
        plan=plan)
    np.testing.assert_allclose(rec["final"], jres.error, rtol=1e-9)
    assert rec["final"] < rec["init"] < rec["initial"]
    assert any(line.startswith("final error") for line in lines)
    g2, v2 = ds.load_3d(out, device="cpu", dtype=F64)
    np.testing.assert_allclose(float(optimizers.graph_error(g2, v2)),
                               rec["final"], rtol=1e-9)
