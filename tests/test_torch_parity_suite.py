"""The port's tools/parity_suite.py against the JAX package's
examples/parity_suite.py on the CPU, one subcommand a test: the same
printed line (numbers below chip_smoke.TOOL_TINY, float noise at an exact
optimum, may differ in their digits) and the same optimizer results. Every
optimize_lm and optimize_gn call that a subcommand makes, GNC's inner ones
included, is captured in both packages and held pairwise: the error to
1e-9 relative (or both below TOOL_TINY), the variables to 1e-8. `lago` and
`pose3_chordal` read seeded stand-ins of noisyToyGraph.txt and
pose3example.txt (chip_smoke.write_noisy_toy_graph, write_pose3_example)
from `data/` under a temporary working directory. The JAX suite runs once,
subcommand by subcommand, in a module-scoped fixture."""

import contextlib
import io
import runpy
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu_torch.nonlinear import optimizers as topt
from gtsam_personal_tpu_torch.tools import parity_suite

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = list(parity_suite.ALL)


def _capturing(mp, module):
    """A list that collects (error, {group: array}) of every optimize_lm
    and optimize_gn result of `module`; clear it to start anew."""
    store = []
    for fn in ("optimize_lm", "optimize_gn"):
        orig = getattr(module, fn)

        def capture(*a, _orig=orig, **k):
            res = _orig(*a, **k)
            store.append((res.error, {g: np.asarray(
                res.values[g].cpu() if hasattr(res.values[g], "cpu")
                else res.values[g]) for g in res.values.groups()}))
            return res
        mp.setattr(module, fn, capture)
    return store


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity_suite")
    (d / "data").mkdir()
    chip_smoke.write_noisy_toy_graph(str(d / "data" / "noisyToyGraph.txt"))
    chip_smoke.write_pose3_example(str(d / "data" / "pose3example.txt"))
    return d


@pytest.fixture(scope="module")
def jax_suite(workdir):
    """{name: (printed lines, optimizer results)} of the JAX suite."""
    suite = runpy.run_path(str(EXAMPLES / "parity_suite.py"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(workdir)
        results = _capturing(mp, jopt)
        for name in NAMES:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                suite["ALL"][name]()
            out[name] = (buf.getvalue().splitlines(), list(results))
            results.clear()
    return out


@pytest.mark.parametrize("name", NAMES)
def test_subcommand(name, jax_suite, workdir, monkeypatch):
    monkeypatch.chdir(workdir)
    lines = []
    results = _capturing(monkeypatch, topt)
    rec = parity_suite.ALL[name]("cpu", lines.append)
    want, jax_results = jax_suite[name]
    assert lines[-1].endswith("  OK")
    assert chip_smoke.tool_lines_gap(lines, want) == []
    assert len(results) == len(jax_results)
    for (e, v), (je, jv) in zip(results, jax_results):
        assert (abs(e) < chip_smoke.TOOL_TINY and abs(je) < chip_smoke.TOOL_TINY
                or abs(e - je) <= 1e-9 * abs(je)), (e, je)
        for g in jv:
            np.testing.assert_allclose(v[g], jv[g], rtol=0, atol=1e-8)
    if name == "combined_imu":
        # what was integrated: 6 keyframes of 100 samples at 5 ms
        assert len(rec["segments"]) == 6
        for accs, gyros, dts in rec["segments"]:
            assert accs.shape == gyros.shape == (100, 3)
            np.testing.assert_array_equal(dts, np.full(100, 0.005))


def test_main_runs_named_subcommands(workdir, monkeypatch, capsys):
    monkeypatch.chdir(workdir)
    parity_suite.main(["kalman_easy", "metis", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [s.split(":")[0] for s in out] == ["kalman_easy", "metis",
                                              "PARITY-SUITE OK"]
