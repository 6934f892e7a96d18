"""The generators, the references against the port at a tiny size in
float64, the roofline counts and the trace reduction."""

import numpy as np
import pytest
import torch

from portbench import harness, roofline, trace
from portbench.gen import manhattan, skewed_bal
from portbench.tests.conftest import ROOT, TINY_TRAFFIC, tiny

MAN = harness.manifest()


def _cfg(name):
    conf = harness.find(MAN["configs"], name, "config")
    cfg = harness.load_json(ROOT / conf["file"])
    cfg.update(tiny(name))
    return cfg


def test_ba_generator_repeats_and_keeps_its_structure():
    cfg = _cfg("bal_ladybug1723")
    a, b = (skewed_bal.make_problem(cfg, 2**31 + 9) for _ in range(2))
    c = skewed_bal.make_problem(cfg, 4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.obs_cam, c.obs_cam)
    np.testing.assert_array_equal(a.obs_point, c.obs_point)
    assert not np.array_equal(a.obs_uv, c.obs_uv)


def test_ba_generator_counts():
    """The full configuration reaches the observation count its file
    states (structure only: no projection of the rows)."""
    conf = harness.find(MAN["configs"], "bal_ladybug1723", "config")
    cfg = harness.load_json(ROOT / conf["file"])
    cam, pt, poses, points = skewed_bal.structure(cfg)
    assert len(cam) == cfg["observations_reached"]
    assert poses.shape == (cfg["num_cameras"], 3, 4)
    assert points.shape == (cfg["num_points"], 3)


def test_manhattan_generator_repeats_and_counts():
    conf = harness.find(MAN["configs"], "city10000_se2", "config")
    cfg = harness.load_json(ROOT / conf["file"])
    a, b = (manhattan.make_graph(cfg, 2**31 + 9) for _ in range(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(a.ij) == cfg["edges_reached"]
    assert a.start.shape == (cfg["num_poses"], 3)
    c = manhattan.make_graph(cfg, 5)
    np.testing.assert_array_equal(a.ij, c.ij)
    assert not np.array_equal(a.measured, c.measured)


# converged solves, under which the stream's estimate is the batch optimum
CONVERGED = {"isam2_tail9000": {"params": {
    "relinearize_threshold": 0.0, "cg_maxiter": 400, "cg_tol": 1e-14,
    "relin_chunk": 256, "precond": "chain:se2"}, "reference_iterations": 40}}


@pytest.mark.parametrize("workload", [w["name"] for w in MAN["workloads"]])
def test_reference_matches_the_port_in_float64(workload):
    """One request of the port in float64 against the plain reference:
    the same algorithm, so they agree to rounding (1e-8 of what the
    request changed). The stream is held to
    the batch optimum with its CG run to convergence and every row
    relinearized."""
    wl = harness.find(MAN["workloads"], workload, "workload")
    cfg = _cfg(wl["config"])
    cfg["dtype"] = "float64"
    traffic = harness.load_json(ROOT / "portbench" / "traffic"
                                / f"{wl['traffic']}.json")
    traffic.update(TINY_TRAFFIC.get(wl["traffic"], {}))
    traffic.update(CONVERGED.get(wl["traffic"], {}))
    path = harness.path_module(traffic["path"])
    if hasattr(path, "calibration"):
        nums, _ = path.calibration(path, cfg, traffic, 7, "cpu", True, False)
    else:
        ctx = path.setup(cfg, traffic, 7, "cpu")
        ans, _ = path.solve(ctx)
        inputs, out = path.reference(cfg, traffic, 7, "cpu")
        nums = path.compare(ans, inputs, out)
    for k, v in nums.items():
        if not k.startswith("look"):
            assert abs(v) <= 1e-8, (k, v)


def test_control_separates_at_a_tiny_size():
    """The TF32 control reads at least ten times the program's numbers at
    a CPU size; on the card the same comparison is made at the cells'
    sizes by calibrate.py."""
    from portbench import calibrate
    for workload, config, key in (
            ("pose_city10000_schur", "city10000_se2", "local_gap"),
            ("isam2_city10000_stream", "city10000_se2", "excess_cost"),
            ("ba_ladybug1723_cm", "bal_ladybug1723", "error_excess")):
        wl = harness.find(MAN["workloads"], workload, "workload")
        out = calibrate.readings(
            workload, [3], [3], device="cpu", cfg_override=tiny(config),
            say=lambda *_: None,
            traffic_override=TINY_TRAFFIC.get(wl["traffic"]))
        assert out["control"][3][key] > 10 * out["program"][3][key], \
            (workload, out)


def test_landmark_block_solve_counts():
    ops, nbytes = roofline.landmark_block_solve(1000, 4)
    assert ops == 48 * 1000                      # counted in the .cu source
    assert nbytes == 12 * 1000 * 4               # 6 of H, 3 of t, 3 of u
    s, by = roofline.least_seconds(ops, nbytes, 4)
    assert by == "bytes" and s == pytest.approx(48000 / 3.35e12)


def test_trace_reduction():
    ev = [{"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
           "ts": 0.0, "dur": 100.0, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::a", "ts": 0.0,
           "dur": 30.0, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::inner", "ts": 5.0,
           "dur": 10.0, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20.0,
           "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 30.0,
           "dur": 30.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 80.0,
           "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "Buffer Flush", "ts": 90.0,
           "dur": 5.0}]
    t = trace.reduce(ev)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(50e-6)      # [20, 60] and [80, 90]
    assert t.kernels["k2"] == [1, pytest.approx(30e-6)]
    assert "Buffer Flush" not in t.kernels
    gaps = dict(t.idle_gaps)
    assert gaps["aten::inner"] == pytest.approx(20e-6)     # [0, 20], mid 10
    assert gaps["host (no operator)"] == pytest.approx(30e-6)  # 60-80, 90-100
    assert trace.kernel(t, "k") == (2, pytest.approx(25e-6))
    assert trace.idle_share({"trace": t}) == pytest.approx(50.0)


def test_tf32_rounding():
    from portbench.reference import lie
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10, 3.0])
    assert lie.tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -10, 3.0]
