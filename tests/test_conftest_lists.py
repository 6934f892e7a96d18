"""The root conftest's list of slow cases names tests that exist; each has
its counterpart in the port's tests, and its JAX functions run under
jax.jit inside tier-1; its sort of the collected items keeps every item
once and each file's order. Reads the test files with `ast`; imports
neither JAX nor torch."""

import ast
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parent.parent

# A counterpart not named `test_torch_<file>.py::<same name>`.
COUNTERPART = {
    "tests/test_parallel.py::test_dryrun_multichip_entrypoint":
        "tests/test_torch_parallel.py::test_dryrun_counterpart",
}

# Where a slow case's JAX functions run under jax.jit in tier-1, if not in
# tests/test_dist_jit.py under the same name.
JITTED = {
    "tests/test_dist_ba.py::test_dist_solve_matches_cm":
        "tests/test_torch_dist_ba.py::test_dist_solve_matches_cm",
    "tests/test_dist_ba_pack.py::test_dist_pack_solve_matches_single_pack":
        "tests/test_torch_dist_ba_pack.py::"
        "test_dist_pack_solve_matches_single_pack",
}
# The JAX dryrun entrypoint has no jitted counterpart.
NOT_JITTED = {"tests/test_parallel.py::test_dryrun_multichip_entrypoint"}


def _load_conftest():
    spec = importlib.util.spec_from_file_location(
        "root_conftest", ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SLOW = sorted(_load_conftest().SLOW)


def _tests(path):
    tree = ast.parse((ROOT / path).read_text())
    return {n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}


def _counterpart(nodeid):
    path, name = nodeid.split("::")
    return COUNTERPART.get(nodeid,
                           path.replace("tests/test_", "tests/test_torch_")
                           + "::" + name)


@pytest.mark.parametrize("nodeid", SLOW)
def test_slow_case_exists(nodeid):
    path, name = nodeid.split("::")
    assert name in _tests(path), nodeid


@pytest.mark.parametrize("nodeid", SLOW)
def test_slow_case_has_port_counterpart(nodeid):
    path, name = _counterpart(nodeid).split("::")
    assert name in _tests(path), (nodeid, path, name)


@pytest.mark.parametrize("nodeid",
                         [n for n in SLOW if n not in NOT_JITTED])
def test_slow_case_jitted_in_tier1(nodeid):
    _, name = nodeid.split("::")
    path, name = JITTED.get(nodeid,
                            "tests/test_dist_jit.py::" + name).split("::")
    assert name in _tests(path), (nodeid, path, name)


def test_sort_keeps_items_and_file_order():
    conftest = _load_conftest()
    seconds = json.loads((ROOT / "tests/file_seconds.json").read_text())
    files = sorted(seconds)[:5] + ["tests/test_not_in_the_table.py"]
    items = [SimpleNamespace(nodeid=f"{f}::test_{k}")
             for k in range(3) for f in files]
    out = list(items)
    conftest.pytest_collection_modifyitems(out)
    assert sorted(map(id, out)) == sorted(map(id, items))
    for f in files:
        assert ([i for i in out if i.nodeid.startswith(f)]
                == [i for i in items if i.nodeid.startswith(f)])
    order = list(dict.fromkeys(i.nodeid.split("::")[0] for i in out))
    assert order == [files[-1]] + sorted(
        files[:-1], key=lambda f: (-seconds[f], f))
