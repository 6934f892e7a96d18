"""The port's data-free tools against the JAX package's examples, in
float64 on the CPU: pose2_slam_example, inverse_kinematics and tutorials
against the lines their examples print (examples/*.py, run in this
process)."""

import contextlib
import io
import re
import runpy
import sys

import numpy as np

from gtsam_personal_tpu_torch.tools import (inverse_kinematics,
                                            pose2_slam_example, tutorials)


# -- tools against their examples --------------------------------------------

def _example_lines(name, argv=()):
    """The lines examples/<name>.py prints (its main(), on the CPU)."""
    out = io.StringIO()
    old = sys.argv
    sys.argv = [name] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            ns = runpy.run_path(f"examples/{name}.py")
            ns["main"]()
    finally:
        sys.argv = old
    return out.getvalue().splitlines()


def _numbers(text):
    return np.array([float(x) for x in re.findall(
        r"-?\d+\.\d*(?:e[-+]?\d+)?|-?\d+(?:e[-+]?\d+)?", text)])


def test_pose2_slam_example_tool():
    """The tool's printed numbers against the example's (errors, poses and
    covariance diagonals), to 1e-6 relative of their printed digits."""
    lines = []
    rec = pose2_slam_example.run(device="cpu", say=lambda s: lines.extend(
        s.splitlines()))
    jlines = _example_lines("pose2_slam_example")
    assert len(lines) == len(jlines)
    for a, b in zip(lines, jlines):
        np.testing.assert_allclose(_numbers(a), _numbers(b), rtol=1e-6,
                                   atol=1e-8, err_msg=f"{a!r} vs {b!r}")
    assert rec["result"].error < 1e-10


def test_inverse_kinematics_tool():
    lines = []
    rec = inverse_kinematics.run(device="cpu", say=lines.append)
    assert rec["ok"]
    assert lines == _example_lines("inverse_kinematics")


def test_tutorials_tool():
    lines = []
    tutorials.run(device="cpu", say=lines.append)
    assert lines == _example_lines("tutorials")
