"""The port's tools/{sfm_example_bal,discrete_examples,hybrid_city10000}.py
against the JAX package's examples of the same names, on the CPU: the same
input files, the same printed lines. Lines that carry a wall time are
compared up to it. The numbers the lines print are rounded (%.6g, %.4f,
%.3f), so equal lines hold the results to those digits; the returned
records are held to the JAX examples' at the tolerances stated below."""

import re
import runpy
import sys

import numpy as np
import pytest

import chip_smoke
from gtsam_personal_tpu.sfm import synthetic as jsyn
from gtsam_personal_tpu_torch.sfm import bal
from gtsam_personal_tpu_torch.tools import (discrete_examples,
                                            hybrid_city10000, sfm_example_bal)

# the first hybrid factors of the stand-in sit on lines 120, 122 and 124
HYBRID_LINES = 125


def _jax_example(name, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [name] + argv)
    capsys.readouterr()
    try:
        runpy.run_path(f"examples/{name}.py", run_name="__main__")
    except SystemExit as e:
        assert not e.code
    return capsys.readouterr().out.splitlines()


def _untimed(line):
    return re.sub(r"\d+\.\d+(s\b| edges/s|s/hybrid update| it/s)", "T",
                  line)


def _same_lines(got, want):
    got = "\n".join(got).splitlines()
    assert [_untimed(s) for s in got] == [_untimed(s) for s in want]


@pytest.fixture(scope="module")
def bal_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bal") / "skewed.txt")
    bal.write_bal(path, jsyn.make_skewed_problem(
        num_cameras=12, num_points=150, mean_track=4.0, max_track=10,
        seed=9, cam_zipf=1.2))
    return path


@pytest.mark.parametrize("engine", ["pack", "cm"])
def test_sfm_example_bal(engine, bal_file, monkeypatch, capsys):
    argv = [bal_file, "--iters", "4", "--engine", engine]
    want = _jax_example("sfm_example_bal", argv, monkeypatch, capsys)
    rec = sfm_example_bal.run(bal_file, 4, engine, device="cpu")
    got = capsys.readouterr().out.splitlines()
    _same_lines(got, want)
    assert rec["final"] < rec["initial"]


def test_discrete_examples(monkeypatch, capsys):
    want = _jax_example("discrete_examples", [], monkeypatch, capsys)
    lines = []
    assert discrete_examples.run("cpu", lines.append)
    assert lines == want


@pytest.fixture(scope="module")
def city_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("city") / "city10000_hybrid.txt")
    return path, chip_smoke.write_city10000_hybrid(path)


def test_hybrid_city10000_isam(city_file, monkeypatch, capsys):
    """At HYBRID_LINES lines (3 mode variables) the ISAM2 engine picks the
    stand-in's true modes and prints the JAX example's lines (final error
    to %.4f, posteriors to %.3f)."""
    path, true_modes = city_file
    argv = [path, "--max-lines", str(HYBRID_LINES)]
    want = _jax_example("hybrid_city10000", argv, monkeypatch, capsys)
    lines = []
    rec = hybrid_city10000.run(path, HYBRID_LINES, 4, "isam", "cpu",
                               lines.append)
    _same_lines(lines, want)
    assert rec["modes"] == 3
    assert rec["assignment"] == {k: true_modes[k] for k in rec["assignment"]}


def test_hybrid_city10000_smoother(city_file):
    """The smoother engine on the same lines picks the same modes. Its
    JAX example is not run here: it jit-compiles a vmapped LM over a graph
    of one batch per edge at every hybrid factor, ~320 s each on a CPU
    at 125 lines; tests/test_torch_hybrid.py holds HybridSmoother to the
    JAX package's on a small stream."""
    path, true_modes = city_file
    lines = []
    rec = hybrid_city10000.run(path, HYBRID_LINES, 4, "smoother", "cpu",
                               lines.append)
    assert lines[0] == f"{HYBRID_LINES} edges over 123 poses (3 ambiguous)"
    assert lines[1].startswith("smoother: 3 discrete modes, final error ")
    assert rec["assignment"] == {k: true_modes[k] for k in range(1000, 1003)}
    assert lines[2] == f"mode assignment: {rec['assignment']}"


def test_hybrid_parser_and_stand_in(city_file):
    """The stand-in: ordered by target pose, tens of ambiguous lines (62,
    the real file's count), at least 3 in the default 150 lines."""
    path, true_modes = city_file
    edges = hybrid_city10000.parse_city10000_hybrid(path, 10 ** 6)
    assert len(true_modes) == chip_smoke.HYBRID_AMBIGUOUS == 62
    assert sum(len(p) > 1 for _, _, p in edges) == 62
    assert sum(len(p) > 1 for _, _, p in edges[:150]) >= 3
    kt = np.array([t for _, t, _ in edges])
    assert (np.diff(kt) >= 0).all() and kt.max() == chip_smoke.POSE_N - 1
