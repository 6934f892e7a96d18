"""Whole runs of each cell at a tiny size on the CPU, the command's
refusal without a card, what a run loads, and the faults that `correct`
has to catch."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT, TINY_TRAFFIC, tiny

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _run(workload, trace=0, seconds=0.5, seed=2**31 + 5):
    wl = harness.find(MAN["workloads"], workload, "workload")
    return harness.run(workload, seed, seconds, trace, time.perf_counter(),
                       device="cpu", cfg_override=tiny(wl["config"]),
                       traffic_override=TINY_TRAFFIC.get(wl["traffic"]))[0]


def test_command_fails_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run(workload, trace):
    res = _run(workload, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(MAN, workload, trace)}
    # on the CPU the device readers (idle share, rooflines) find nothing,
    # nor does a tail in a window this short
    readable = {n for n in names if not n.startswith("device_idle")
                and "roofline" not in n and not n.endswith("_p95")}
    assert readable <= set(res["metrics"]) <= names
    for m in res["metrics"].values():
        assert m["value"] > 0
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_loads_no_jax(workload):
    wl = harness.find(MAN["workloads"], workload, "workload")
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from portbench import harness; "
            "from portbench.tests.conftest import TINY_TRAFFIC, tiny; "
            f"harness.run({workload!r}, 3, 0.2, 0, time.perf_counter(), "
            f"device='cpu', cfg_override=tiny({wl['config']!r}), "
            f"traffic_override=TINY_TRAFFIC.get({wl['traffic']!r})); "
            "print(harness.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _altered(real, pick):
    """Every hundredth row of the answer moved by 0.05 where it is
    produced."""
    def fn(*args, **kw):
        out = real(*args, **kw)
        pick(out)[::100] += 0.05
        return out
    return fn


def _unchanged_cm(state, obs, layout=None, max_iterations=50,
                  lambda_initial=1e-4, cg_maxiter=100, probe=None, **kw):
    from gtsam_personal_tpu_torch.sfm import ba
    probe("error", error=None)
    return state, float(ba.ba_error(state, obs)), 1


def _unchanged_pose(graph, values, lam, err, n_iters, params, plan):
    return values, torch.tensor(lam), torch.as_tensor(err)


def _unchanged_isam2(real):
    """An update that stages its measurement and leaves the estimate as it
    was (the staged start of a new pose); it takes an update's time, so
    that the window does not outrun the stream."""
    def update(self, extra_cg=0):
        self._flush_staged()
        time.sleep(0.02)
        return real.__globals__["ISAM2Result"]()
    return update


def _altered_estimate(real):
    def fn(self):
        v = real(self)
        v["se2"][::100] += 0.05
        return v
    return fn


FAULTS = {
    "pose_city10000_schur": (
        "gtsam_personal_tpu_torch.nonlinear.optimizers", "lm_run",
        {"unchanged": lambda real: _unchanged_pose,
         "altered": lambda real: _altered(real, lambda o: o[0]["se2"])}),
    "isam2_city10000_stream": (
        "gtsam_personal_tpu_torch.nonlinear.isam2.ISAM2", "update",
        {"unchanged": _unchanged_isam2}),
    "isam2_city10000_stream.altered": (
        "gtsam_personal_tpu_torch.nonlinear.isam2.ISAM2",
        "calculate_estimate", {"altered": _altered_estimate}),
    "ba_ladybug1723_cm": (
        "gtsam_personal_tpu_torch.sfm.ba", "optimize_ba",
        {"unchanged": lambda real: _unchanged_cm,
         "altered": lambda real: _altered(real, lambda o: o[0].points)}),
}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    """The timed path broken underneath: a request that returns its state
    unchanged, and one whose answer is altered where it is produced."""
    import importlib
    key = workload if fault in FAULTS[workload][2] else f"{workload}.{fault}"
    where, fn_name, faults = FAULTS[key]
    mod_name, _, cls = where.rpartition(".") if where.endswith(
        ".ISAM2") else (where, None, None)
    owner = importlib.import_module(mod_name)
    if cls:
        owner = getattr(owner, cls)
    monkeypatch.setattr(owner, fn_name, faults[fault](getattr(owner,
                                                             fn_name)))
    # a stream's fault shows over many updates
    res = _run(workload, seconds=3.0 if "isam2" in workload else 0.5)
    assert res["correct"] is False, res["checks"]


def test_result_line_is_json():
    res = _run(CELLS[0])
    line = json.dumps(res)
    assert json.loads(line)["device"]["count"] == 1


def test_stream_window_ends_with_the_stream():
    """A window longer than the stream ends when only the traced stretch's
    measurements are left, and the run stays correct."""
    res = _run("isam2_city10000_stream", trace=1, seconds=600.0)
    t = harness.load_json(ROOT / "portbench" / "traffic"
                          / "isam2_tail9000.json")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 100
    assert "isam2_cg_iters" in res["metrics"]
    assert t["trace_solves"] > 0


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, card):
    """A short run of each cell at its full size on the card, traced:
    correct, with its per-layer metrics and a breakdown."""
    res, _ = harness.run(workload, 2**31 + 11, 2.0, 1, time.perf_counter(),
                         device=card)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0 and res["breakdown"]["device_ops"]
