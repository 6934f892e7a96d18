"""The port's tools/{visual_isam2,pose2_m3500,view_graph}.py against the
JAX package's examples of the same names, on the CPU: the same arguments,
the same printed lines (wall times masked, chip_smoke.tool_lines_gap) and
numbers at chip_smoke.tool_record_gap's tolerances. visual_isam2's stream
runs with CG to convergence in both engines (chip_smoke.ISAM2_CONVERGED,
ROADMAP queue 3 A7): its error and the batch error to 1e-9 relative,
estimates to 1e-8. pose2_m3500 at `--n 600 --solver dense`: error to 1e-9
relative, poses to 1e-8. view_graph: the iterations equal, both errors
below 1e-12, the four edges one pose apart to 1e-8; the four two apart
are not determined beyond ~1e-5 by the 96 factors (LM moves them along a
direction of nearly zero curvature by float noise over lambda), so their
printed errors are held to the example's gate, 1e-4
(chip_smoke.VIEW_GRAPH_LOOSE)."""

import functools
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from gtsam_personal_tpu.nonlinear import isam2 as jisam2
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu_torch.tools import pose2_m3500, view_graph, visual_isam2

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def run_jax_example(name, argv, monkeypatch, capsys):
    """The JAX example's main as a script in-process; its stdout lines."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    try:
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    except SystemExit as e:
        assert not e.code
    return capsys.readouterr().out.splitlines()


def capture_lm(monkeypatch):
    got = []
    orig = jopt.optimize_lm

    def capture(*a, **k):
        got.append(orig(*a, **k))
        return got[-1]
    monkeypatch.setattr(jopt, "optimize_lm", capture)
    return got


def blocks(values):
    return {g: np.asarray(values[g]) for g in values.groups()}


def assert_same(name, port_rec, jax_numbers, got_lines, want_lines,
                loose=()):
    assert chip_smoke.tool_lines_gap(got_lines, want_lines, loose) == []
    for what, gap, limit in chip_smoke.tool_record_gap(
            name, chip_smoke.tool_numbers(name, port_rec), jax_numbers):
        assert gap <= limit, (what, gap, limit)


def test_visual_isam2(monkeypatch, capsys):
    """The example's defaults (8 poses, the cube's corners)."""
    got = capture_lm(monkeypatch)
    engines = []

    class Captured(jisam2.ISAM2):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)
    monkeypatch.setattr(jisam2, "ISAM2", Captured)
    monkeypatch.setattr(jisam2, "ISAM2Params", functools.partial(
        jisam2.ISAM2Params, **chip_smoke.ISAM2_CONVERGED))
    want = run_jax_example("visual_isam2", [], monkeypatch, capsys)
    lines = []
    rec = visual_isam2.run(device="cpu", say=lines.append,
                           **chip_smoke.ISAM2_CONVERGED)
    assert rec["ok"] and want[-1] == "VISUAL-ISAM2 OK"
    (isam,) = engines
    assert_same("visual_isam2", rec,
                {"error": isam.error(), "batch": got[-1].error,
                 "estimate": blocks(isam.calculate_estimate())},
                lines, want)


def test_visual_isam2_scene():
    """make_scene at 32 seeded points equals the JAX example's."""
    jv = runpy.run_path(str(EXAMPLES / "visual_isam2.py"))
    for n, m in ((8, 8), (40, 32)):
        for got, want in zip(visual_isam2.make_scene(n, m),
                             jv["make_scene"](n, m)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def m3500_dense():
    return pose2_m3500.run(chip_smoke.TOOL_CUT_M3500, solver="dense",
                           device="cpu", say=lambda *_: None)


def test_pose2_m3500(m3500_dense, monkeypatch, capsys):
    """`--n 600 --solver dense`; LM's verbose lines are on stdout in both
    packages."""
    got = capture_lm(monkeypatch)
    argv = ["--n", str(chip_smoke.TOOL_CUT_M3500), "--solver", "dense"]
    want = run_jax_example("pose2_m3500", argv, monkeypatch, capsys)
    assert pose2_m3500.main(argv + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    res = got[-1]
    assert_same("pose2_m3500", m3500_dense,
                {"error": res.error, "values": blocks(res.values)},
                lines, want)


@pytest.mark.parametrize("solver", ["schur", "pcg"])
def test_pose2_m3500_solvers(m3500_dense, solver):
    """The tool's other two solvers reach the dense run's optimum."""
    rec = pose2_m3500.run(chip_smoke.TOOL_CUT_M3500, solver=solver,
                          device="cpu", say=lambda *_: None)
    assert rec["ok"]
    np.testing.assert_allclose(rec["result"].error,
                               m3500_dense["result"].error, rtol=1e-8)
    np.testing.assert_allclose(rec["ate"], m3500_dense["ate"], rtol=1e-6)


def test_view_graph(monkeypatch, capsys):
    got = capture_lm(monkeypatch)
    want = run_jax_example("view_graph", [], monkeypatch, capsys)
    assert view_graph.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    rec = view_graph.run(device="cpu", say=lambda *_: None)
    res = got[-1]
    from gtsam_personal_tpu.geometry import fundamental as jfund
    assert_same("view_graph", rec,
                {"iterations": res.iterations, "error": res.error,
                 "F": np.stack([np.asarray(jfund.fundamental_matrix(f))
                                for f in res.values["fundamental"]])},
                lines, want, chip_smoke.VIEW_GRAPH_LOOSE)
    assert rec["worst"] < 1e-4
