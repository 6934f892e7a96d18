"""CPU tests of the benchmark harness (python -m pytest portbench/tests).

Tests that need a CUDA card carry the `card` marker and take the `card`
fixture, which skips them where there is none; run them on the card with
`python -m pytest portbench/tests -m card`."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes of each configuration, for the CPU
TINY = {
    "bal_ladybug1723": {"num_cameras": 29, "num_points": 300},
    "city10000_se2": {"num_poses": 300, "closure_min_gap": 50},
}
# traffic that the tiny sizes need
TINY_TRAFFIC = {"isam2_tail9000": {"from_pose": 150, "calibrate_updates": 20,
                                   "warmup_updates": 2}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


def tiny(config_name):
    """The override of a configuration that makes it CPU-sized."""
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{config_name}.json").read_text())
    out = {k: v for k, v in TINY[config_name].items() if k in cfg}
    assumed = {k: v for k, v in TINY[config_name].items()
               if k in cfg["assumed"]}
    if assumed:
        out["assumed"] = dict(cfg["assumed"], **assumed)
    return out


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
