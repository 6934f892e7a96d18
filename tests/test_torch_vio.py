"""The port's IMU + GPS fusion tool (gtsam_personal_tpu_torch/tools/
imu_gps_vio.py) against the JAX package's example (examples/imu_gps_vio.py,
loaded by path, run on the CPU), float64, on a seeded stand-in of the
reference's recorded file written by chip_smoke.py:write_imu_gps_csv.

The stand-in here has 20 IMU samples per GPS fix (the format's 200 Hz, a
fix every 0.1 s), so that the port's plain preintegration, a Python loop
over the samples, keeps the file within its time; chip_smoke.py runs the
file's own 200 samples per fix on the card.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gtsam_personal_tpu.nonlinear import optimizers as jopt
from gtsam_personal_tpu_torch.navigation import preintegration as pre
from gtsam_personal_tpu_torch.tools import imu_gps_vio as vio

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

N_FIXES = 10
F64 = torch.float64


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_imu_gps_vio", REPO / "examples" / "imu_gps_vio.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    path = tmp_path_factory.mktemp("vio") / "standin.csv"
    truth = chip_smoke.write_imu_gps_csv(str(path), N_FIXES, seed=3,
                                         samples_per_fix=20)
    return str(path), truth


@pytest.fixture(scope="module")
def jv():
    return _jax_example()


def test_loader_matches_jax(data, jv):
    path, truth = data
    ji, js, jg = jv.load_imu_gps_csv(path)
    ti, ts, tg = vio.load_imu_gps_csv(path)
    assert np.array_equal(ji, ti)
    assert len(js) == len(ts) == len(jg) == len(tg) == N_FIXES
    for a, b in zip(js + jg, ts + tg):
        assert np.array_equal(a, b)
    assert np.array_equal(jv.quat_to_rot(*ti[3:7]),
                          vio.quat_to_rot(*ti[3:7]))
    q = np.array([0.1, -0.3, 0.2, 0.9])
    assert np.array_equal(jv.quat_to_rot(*q), vio.quat_to_rot(*q))
    assert np.array_equal(vio.quat_to_rot(0, 0, 0, 0), np.eye(3))
    assert truth.shape == (N_FIXES, 3)
    np.testing.assert_allclose(np.stack([g[:3] for g in tg]), truth,
                               atol=6 * chip_smoke.VIO_GPS_SIGMA)
    for k in pre.PreintegrationParams._fields:
        np.testing.assert_array_equal(
            getattr(vio.imu_params(device="cpu"), k).numpy(),
            np.asarray(getattr(jv.imu_params(), k)))


def test_run_batch_matches_jax(data, jv, monkeypatch):
    path, truth = data
    got = {}
    orig = jopt.optimize_lm

    def capture(*a, **k):
        got["res"] = orig(*a, **k)
        return got["res"]
    monkeypatch.setattr(jopt, "optimize_lm", capture)
    init, segs, gps = vio.load_imu_gps_csv(path)
    pose0, vel0 = vio.initial_state(init)
    jv.run_batch(pose0, vel0, segs, gps, N_FIXES, jv.imu_params())
    rec = vio.run_batch(pose0, vel0, segs, gps, N_FIXES, device="cpu",
                        dtype=F64)
    res, jres = rec["result"], got["res"]
    np.testing.assert_allclose(res.error, jres.error, rtol=1e-9)
    assert res.iterations == jres.iterations
    for g in ("se3", "vel3", "imu_bias"):
        np.testing.assert_allclose(res.values[g].numpy(),
                                   np.asarray(jres.values[g]), rtol=0,
                                   atol=1e-7)
    err = vio.position_errors(res.values["se3"][1:, :, 3].numpy(), gps,
                              N_FIXES, truth)
    assert err.mean() < 1.0
    # the partitioned-Schur plan takes the three groups of the timesteps
    sch = vio.run_batch(pose0, vel0, segs, gps, N_FIXES, device="cpu",
                        dtype=F64, solver="schur", max_part=4,
                        say=lambda *_: None)
    np.testing.assert_allclose(sch["result"].error, res.error, rtol=1e-9)
    np.testing.assert_allclose(sch["result"].values["se3"].numpy(),
                               res.values["se3"].numpy(), rtol=0, atol=1e-7)
    # the GPS-aided start of long drives reaches the same optimum
    gs = vio.run_batch(pose0, vel0, segs, gps, N_FIXES, device="cpu",
                       dtype=F64, start="gps", say=lambda *_: None)
    np.testing.assert_allclose(gs["result"].error, res.error, rtol=1e-8)
    with pytest.raises(ValueError, match="start"):
        vio.run_batch(pose0, vel0, segs, gps, N_FIXES, device="cpu",
                      dtype=F64, start="truth", say=lambda *_: None)


def test_stream_matches_jax(data, jv, monkeypatch):
    """The ISAM2 stream, 3 updates per fix and 4 polishing updates: the
    JAX example's engine (captured as main() builds it) against the
    port's, tolerance as tests/test_torch_isam2.py's superchain stream: the
    stiff IMU rows weigh ~1e7 times the GPS rows, and rounding in the stiff
    part moves the weakly held directions by that much more."""
    path, _ = data
    engines = []

    class Captured(jv.ISAM2):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            engines.append(self)
    monkeypatch.setattr(jv, "ISAM2", Captured)
    monkeypatch.setattr(sys, "argv", ["imu_gps_vio", "--data", path, "--n",
                                      str(N_FIXES)])
    jv.main()
    (jisam,) = engines
    init, segs, gps = vio.load_imu_gps_csv(path)
    pose0, vel0 = vio.initial_state(init)
    isam, recs = vio.run_stream(pose0, vel0, segs, gps, N_FIXES,
                                device="cpu", dtype=F64, say=lambda *_: None)
    assert len(recs) == N_FIXES + 1 and all(len(u) == 3 for _, u in recs[:-1])
    for g in ("se3", "vel3", "imu_bias"):
        a, b = isam.estimate_array(g), jisam.estimate_array(g)
        assert a.shape == b.shape == (N_FIXES + 1,) + b.shape[1:]
        assert np.abs(a - b).max() < 1e-5, g
    np.testing.assert_allclose(isam.error(), jisam.error(), rtol=1e-6)
