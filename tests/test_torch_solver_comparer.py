"""The port's tools/solver_comparer.py against the JAX package's
examples/solver_comparer.py, in float64 on the CPU, on a 100-pose
Manhattan world (seed 3) that slam/dataset.py:write_g2o_2d writes: the
same printed lines, and each direct solver's final error to 1e-9 relative
of the JAX run's (PCG's to 1e-3: CG stops at its cap); the snapshot,
`--compare` and `--incremental` modes."""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu_torch.slam import dataset, manhattan
from gtsam_personal_tpu_torch.tools import solver_comparer

SOLVERS = "dense,schur,pcg,qr,sequential"
EXAMPLE = Path(__file__).resolve().parent.parent / "examples" / \
    "solver_comparer.py"


@pytest.fixture(scope="module")
def g2o_file(tmp_path_factory):
    g, v, _ = manhattan.make_manhattan(100, seed=3, device="cpu",
                                       dtype=torch.float64)
    path = tmp_path_factory.mktemp("solver_comparer") / "m100.g2o"
    dataset.write_g2o_2d(str(path), v, g)
    return str(path)


def _jax_example(path, monkeypatch, capsys):
    """The JAX example's printed lines and the Result of each solver."""
    spec = importlib.util.spec_from_file_location("jax_solver_comparer",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    results = {}
    real = jopt.optimize_lm

    def recording(graph, values, params, **kw):
        results[params.solver] = real(graph, values, params, **kw)
        return results[params.solver]
    monkeypatch.setattr(jopt, "optimize_lm", recording)
    monkeypatch.setattr("sys.argv", ["solver_comparer.py", path,
                                     "--solvers", SOLVERS])
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out.splitlines(), results


def _errors(lines):
    return {m.group(1): m.group(2) for m in
            (re.match(r"\s+(\w+)\s*: error (\S+) in (\d+) iters", ln)
             for ln in lines) if m}


def test_batch_solvers_match_the_jax_example(g2o_file, monkeypatch, capsys):
    jlines, jres = _jax_example(g2o_file, monkeypatch, capsys)
    lines = []
    rec = solver_comparer.run(g2o_file, solvers=SOLVERS, device="cpu",
                              say=lines.append)
    assert lines[:2] == jlines[:2]          # poses, factors, initial error
    errors, jerrors = _errors(lines), _errors(jlines)
    assert list(errors) == list(jerrors)
    for s, res in rec["results"].items():
        if s == "pcg":
            # CG stops at its cap (250) or tolerance: two implementations
            # agree to the cap's accuracy, not to rounding
            assert res.error == pytest.approx(float(jres[s].error),
                                              rel=1e-3)
            continue
        assert errors[s] == jerrors[s], s
        assert res.iterations == jres[s].iterations, s
        assert res.error == pytest.approx(float(jres[s].error), rel=1e-9), s
    assert rec["best"] in ("dense", "schur", "qr", "sequential")
    # the direct solvers agree with each other
    for s in ("schur", "qr", "sequential"):
        assert rec["diffs"][s] < 1e-9, s


def test_snapshot_compare_and_incremental(g2o_file, tmp_path):
    a, b = str(tmp_path / "A"), str(tmp_path / "B")
    lines = []
    rec = solver_comparer.run(g2o_file, solvers="dense,schur",
                              with_incremental=True, snapshot=a,
                              device="cpu", say=lines.append)
    assert lines[-1] == f"snapshot -> {a}"
    assert any(ln.startswith("  incremental vs batch ATE: ") for ln in lines)
    # the file's error is small (its information is read as a covariance,
    # noise_format="auto"), and batch LM stops at its absolute tolerance
    # 1e-5: the stream ends at or below the batch error
    assert rec["incremental_error"] <= 1.05 * rec["results"]["dense"].error
    solver_comparer.run(g2o_file, solvers="sequential", snapshot=b,
                        device="cpu", say=lambda _: None)
    out = []
    diffs = solver_comparer.compare(a, b, say=out.append)
    assert list(diffs) == ["se2"] and diffs["se2"][0] < 1e-9
    assert out[0].startswith("se2: max |diff| ")
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            solver_comparer.main([g2o_file])
