"""BENCHMARK.json against the benchmark's contract, and every name it
holds found as a file of the harness."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word


def test_budget_fits_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
        if text is not None:
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entries(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    reader = harness.load_reader(m["name"])
    assert callable(reader)
    for w in m.get("workloads", []):
        harness.find(MAN["workloads"], w, "workload")
    if m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        # the metric it moves is reported in each of its cells
        moved = harness.find(MAN["end_to_end"], m["moves"], "metric")
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("wl", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files(wl):
    conf = harness.find(MAN["configs"], wl["config"], "config")
    assert conf["file"].startswith("portbench/")
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["reduced"] == conf["reduced"] == []
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / f"{wl['traffic']}.json").read_text())
    path = harness.path_module(traffic["path"])
    for fn in ("setup", "solve", "failed", "spans", "shapes", "reference",
               "compare", "as_answer"):
        assert callable(getattr(path, fn))
    limits = json.loads((ROOT / "portbench" / "limits"
                         / f"{wl['name']}.json").read_text())
    assert limits and all(v > 0 for v in limits.values())
    assert wl["chips"] in (1, 4)
    e2e = harness.cell_metrics(MAN, wl["name"], False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.cell_metrics(MAN, wl["name"], True)


def test_every_config_used_and_layers_named_once():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


BANNED = set(harness.BANNED)


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_import_in_sources():
    """No file of the harness outside its tests imports a module whose
    top-level name is jax, jaxlib, flax or gtsam_personal_tpu (compared
    whole: the port's own name begins with the last)."""
    for f in (ROOT / "portbench").rglob("*.py"):
        if "tests" in f.relative_to(ROOT / "portbench").parts:
            continue
        for mod in _imports(f):
            assert mod.split(".")[0] not in BANNED, (f, mod)


def test_references_import_nothing_of_the_program():
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top in ("torch", "numpy", "portbench"), (f, mod)
            assert not mod.startswith("portbench.") or \
                mod.startswith("portbench.reference"), (f, mod)


def test_banned_compared_whole():
    import gtsam_personal_tpu_torch  # noqa: F401
    assert "gtsam_personal_tpu_torch" not in harness.banned_modules()
