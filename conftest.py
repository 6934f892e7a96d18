"""Tier-1 ordering for `pytest tests/`: which cases run only under
`-m slow`, and the order in which `--dist loadfile` hands out files."""

import json
import math
from pathlib import Path

import pytest

# Eager shard_map on the 8-device CPU mesh takes minutes a case (CHANGES.md).
# The port's same-named tests in tests/test_torch_*.py compare against the
# first case of each dist file under jax.jit; tests/test_dist_jit.py runs the
# other five's JAX checks under jax.jit. The dryrun's counterpart,
# tests/test_torch_parallel.py::test_dryrun_counterpart, runs the port only.
# These run under `-m slow`.
SLOW = frozenset({
    "tests/test_dist_ba.py::test_dist_solve_matches_cm",
    "tests/test_dist_ba.py::test_dist_try_step_reduces_error",
    "tests/test_dist_ba.py::test_ownership_partitioned_layout_matches",
    "tests/test_dist_ba.py::test_partition_points_off_matches",
    "tests/test_dist_ba_pack.py::test_dist_pack_solve_matches_single_pack",
    "tests/test_dist_ba_pack.py::test_dist_pack_try_step_reduces_error",
    "tests/test_dist_ba_pack.py::test_dist_pack_lone_device",
    "tests/test_parallel.py::test_dryrun_multichip_entrypoint",
})


def pytest_itemcollected(item):
    if item.nodeid in SLOW:
        item.add_marker(pytest.mark.slow)


def pytest_configure(config):
    # `--dist loadfile` then hands out files in collection order, which
    # the hook below makes longest first.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(items):
    """Order files by their seconds in a full run (tests/file_seconds.json,
    from its junit XML), largest first; files not in it first, ties by
    path. The sort is stable, so a file keeps its own order."""
    seconds = json.loads(
        (Path(__file__).parent / "tests/file_seconds.json").read_text())

    def key(item):
        path = item.nodeid.split("::", 1)[0]
        return -seconds.get(path, math.inf), path

    items.sort(key=key)
