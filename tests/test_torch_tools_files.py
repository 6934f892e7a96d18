"""The port's tools/{stereo_vo_large,victoria_park,range_isam_plaza2}.py
against the JAX package's examples of the same names, on the CPU, on
seeded stand-ins of the reference's files (chip_smoke.py's writers) in a
temporary working directory, where both packages' find_example_data look
(`data/`). The readers give the JAX examples' arrays; the tools print the
JAX examples' lines (wall times masked, chip_smoke.tool_lines_gap) and
their numbers agree at chip_smoke.tool_record_gap's tolerances: the batch
LM runs' error to 1e-9 relative and variables to 1e-8. The Plaza2 stream
runs with CG to convergence in both engines (chip_smoke.ISAM2_CONVERGED,
ROADMAP queue 3 A7) and is held to chip_smoke.PLAZA2_LIMITS: its
range-only problem is ill-conditioned, so the two packages' float64
factorizations of the batch start already differ by ~5e-12 relative in
the error and the streams end ~1e-8 m apart. One cut size per JAX
function: VO at 400 factors, Victoria Park `--n 800`, Plaza2 `--steps
500`."""

import functools
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from gtsam_personal_tpu.nonlinear import isam2 as jisam2
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu_torch.tools import (range_isam_plaza2, stereo_vo_large,
                                            victoria_park)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory with the stand-ins in data/: VO cut to
    TOOL_CUT_VO, the full Victoria Park and Plaza2 files (the tools cut
    them with their flags)."""
    d = tmp_path_factory.mktemp("tools_files")
    (d / "data").mkdir()
    chip_smoke.write_vo_large(str(d / "data"), **chip_smoke.TOOL_CUT_VO)
    chip_smoke.write_victoria_park(str(d / "data" / "victoria_park.txt"))
    chip_smoke.write_plaza2(str(d / "data"))
    return d


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
    """A list that collects every JAX optimize_lm Result."""
    got = []
    orig = jopt.optimize_lm

    def capture(*a, **k):
        got.append(orig(*a, **k))
        return got[-1]
    monkeypatch.setattr(jopt, "optimize_lm", capture)
    return got


def blocks(values):
    return {g: np.asarray(values[g]) for g in values.groups()}


def lm_numbers(res):
    return {"error": res.error, "values": blocks(res.values)}


def assert_same(name, port_rec, jax_numbers, got_lines, want_lines):
    assert chip_smoke.tool_lines_gap(got_lines, want_lines) == []
    for what, gap, limit in chip_smoke.tool_record_gap(
            name, chip_smoke.tool_numbers(name, port_rec), jax_numbers):
        assert gap <= limit, (what, gap, limit)


# -- readers -------------------------------------------------------------------

def test_vo_reader(workdir, monkeypatch):
    """load_vo is np.loadtxt of the three files; first_sightings is the
    JAX example's landmark loop (index in order of first appearance, the
    first sighting's row)."""
    monkeypatch.chdir(workdir)
    calib, rows, fac = stereo_vo_large.load_vo()
    for got, name in ((calib, "VO_calibration.txt"),
                      (rows, "VO_camera_poses_large.txt"),
                      (fac, "VO_stereo_factors_large.txt")):
        np.testing.assert_array_equal(got, np.loadtxt(f"data/{name}"))
    assert fac.shape == (400, 8) and rows.shape == (25, 17)
    l_id = fac[:, 1].astype(int)
    lmap, first = {}, []
    for i, l in enumerate(l_id):
        if l not in lmap:
            lmap[l] = len(lmap)
            first.append(i)
    ix, fr = stereo_vo_large.first_sightings(l_id)
    np.testing.assert_array_equal(ix, [lmap[l] for l in l_id])
    np.testing.assert_array_equal(fr, first)


@pytest.mark.parametrize("n_limit", [None, 800])
def test_victoria_reader(workdir, n_limit):
    """load_victoria's arrays equal the JAX example's tuples, whole and
    cut; the stand-in has the example's counts."""
    path = str(workdir / "data" / "victoria_park.txt")
    jv = runpy.run_path(str(EXAMPLES / "victoria_park.py"))
    j_odo, j_lmk = jv["load_victoria"](path, n_limit)
    odo, lmk = victoria_park.load_victoria(path, n_limit)
    np.testing.assert_array_equal(odo["ij"], [o[:2] for o in j_odo])
    np.testing.assert_array_equal(odo["d"], [o[2] for o in j_odo])
    np.testing.assert_array_equal(odo["cov"], [o[3] for o in j_odo])
    np.testing.assert_array_equal(lmk["pj"], [x[:2] for x in j_lmk])
    np.testing.assert_array_equal(lmk["xy"], [x[2] for x in j_lmk])
    np.testing.assert_array_equal(lmk["cov"], [x[3] for x in j_lmk])
    if n_limit is None:
        assert len(np.unique(odo["ij"])) == chip_smoke.VICTORIA_POSES
        assert len(np.unique(lmk["pj"][:, 1])) == \
            chip_smoke.VICTORIA_LANDMARKS
        assert not np.isin(lmk["pj"][:, 1], odo["ij"]).any()


def test_plaza2_reader(workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    jp = runpy.run_path(str(EXAMPLES / "range_isam_plaza2.py"))
    for got, want in zip(range_isam_plaza2.load_plaza2(), jp["load_plaza2"]()):
        np.testing.assert_array_equal(got, want)
    dr, td = range_isam_plaza2.load_plaza2()
    assert dr.shape == (chip_smoke.PLAZA2_STEPS, 3)
    assert td.shape == (chip_smoke.PLAZA2_RANGES, 4)
    assert set(td[:, 2].astype(int)) == set(chip_smoke.PLAZA2_BEACON_IDS)
    assert (np.diff(td[:, 0]) >= 0).all()


# -- tools ---------------------------------------------------------------------

def test_stereo_vo_large(workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    got = capture_lm(monkeypatch)
    want = run_jax_example("stereo_vo_large", [], monkeypatch, capsys)
    lines = []
    rec = stereo_vo_large.run(device="cpu", say=lines.append)
    assert rec["ok"] and want[-1] == "STEREO-VO OK"
    assert_same("stereo_vo_large", rec, lm_numbers(got[-1]), lines, want)


@pytest.mark.parametrize("robust", [False, True])
def test_victoria_park(workdir, robust, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    got = capture_lm(monkeypatch)
    argv = ["--n", str(chip_smoke.TOOL_CUT_VICTORIA)] + \
        (["--robust"] if robust else [])
    want = run_jax_example("victoria_park", argv, monkeypatch, capsys)
    lines = []
    rec = victoria_park.run(chip_smoke.TOOL_CUT_VICTORIA, robust=robust,
                            device="cpu", say=lines.append)
    assert rec["ok"] and want[-1] == "VICTORIA-PARK OK"
    assert_same("victoria_park", rec, lm_numbers(got[-1]), lines, want)


def test_range_isam_plaza2(workdir, monkeypatch, capsys):
    """The stream with CG run to convergence in both engines (the JAX
    ISAM2Params' fields set through the class the example calls)."""
    monkeypatch.chdir(workdir)
    got = capture_lm(monkeypatch)
    engines = []

    class Captured(jisam2.ISAM2):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)
    monkeypatch.setattr(jisam2, "ISAM2", Captured)
    monkeypatch.setattr(jisam2, "ISAM2Params", functools.partial(
        jisam2.ISAM2Params, **chip_smoke.ISAM2_CONVERGED))
    argv = ["--steps", str(chip_smoke.TOOL_CUT_PLAZA2)]
    want = run_jax_example("range_isam_plaza2", argv, monkeypatch, capsys)
    lines = []
    rec = range_isam_plaza2.run(chip_smoke.TOOL_CUT_PLAZA2, device="cpu",
                                say=lines.append,
                                **chip_smoke.ISAM2_CONVERGED)
    assert rec["ok"] and want[-1] == "PLAZA2 OK"
    (isam,) = engines
    jax_numbers = {"error": isam.error(), "batch": got[0].error,
                   "estimate": blocks(isam.calculate_estimate())}
    assert_same("range_isam_plaza2", rec, jax_numbers, lines, want)


def test_tools_raise_without_a_card():
    """No fallback: the default device is the card, and asking for it
    where there is none raises before any work."""
    assert not torch.cuda.is_available()
    for tool in chip_smoke.TOOL_MODULES.values():
        with pytest.raises(RuntimeError, match="cuda"):
            tool.run(say=lambda *_: None)
