"""The reference's small tutorial examples, end to end with asserts.

    python -m gtsam_personal_tpu_torch.tools.tutorials [--device cuda]

JAX counterpart: examples/tutorials.py (the reference's
OdometryExample.cpp, LocalizationExample.cpp, PlanarSLAMExample.cpp,
SimpleRotation.cpp, CameraResectioning.cpp and SelfCalibrationExample.cpp):
each is a function that asserts the reference's known outcome and returns
what it estimated. Prints TUTORIALS OK at the end. The device is the card
unless `--device cpu` asks for the CPU.
"""

import argparse

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import cameras as cam_geo, se2, se3
from gtsam_personal_tpu_torch.geometry import so2
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam import factors as F

F64 = torch.float64


def _optimize(b, init_dict, dev, iters=30):
    return optimizers.optimize_lm(
        b.build(device=dev, dtype=F64),
        values_from_numpy(init_dict, device=dev, dtype=F64),
        optimizers.Params(max_iterations=iters))


def _host(x):
    return torch.as_tensor(x, dtype=F64)


def odometry_example(dev, say=print):
    """OdometryExample.cpp: a prior at the origin, two (2, 0, 0)
    odometries."""
    b = GraphBuilder()
    F.add_prior(b, "se2", 0, np.zeros(3), F.diag_noise([0.3, 0.3, 0.1]))
    for i in range(2):
        F.add_between(b, "se2", i, i + 1, np.array([2.0, 0.0, 0.0]),
                      F.diag_noise([0.2, 0.2, 0.1]))
    res = _optimize(b, {"se2": np.full((3, 3), 0.1)}, dev)
    got = res.values["se2"].cpu().numpy()
    np.testing.assert_allclose(got[:, 0], [0, 2, 4], atol=1e-8)
    np.testing.assert_allclose(got[:, 1:], 0, atol=1e-8)
    say(f"odometry: poses x = {np.round(got[:, 0], 6).tolist()}  OK")
    return got


def _unary_gps(xs, meas):
    (pose,) = xs
    return pose[:2] - meas["measured"]


def localization_example(dev, say=print):
    """LocalizationExample.cpp: odometry and GPS-like unary position
    factors (the reference's custom UnaryFactor)."""
    b = GraphBuilder()
    for i in range(2):
        F.add_between(b, "se2", i, i + 1, np.array([2.0, 0.0, 0.0]),
                      F.diag_noise([0.2, 0.2, 0.1]))
    for i, xy in enumerate([(0.0, 0.0), (2.0, 0.0), (4.0, 0.0)]):
        b.add("gps", _unary_gps, ("se2",), 2, [i],
              {"measured": np.asarray(xy)},
              {"kind": "diag", "data": np.full(2, 10.0)})
    res = _optimize(b, {"se2": np.array([[0.5, 0.0, 0.2], [2.3, 0.1, -0.2],
                                         [4.1, 0.1, 0.1]])}, dev)
    got = res.values["se2"].cpu().numpy()
    np.testing.assert_allclose(got[:, 0], [0, 2, 4], atol=1e-6)
    say(f"localization: poses x = {np.round(got[:, 0], 6).tolist()}  OK")
    return got


def planar_slam_example(dev, say=print):
    """PlanarSLAMExample.cpp: 3 poses, 2 landmarks, bearing-range factors;
    the landmarks are at (2, 2) and (4, 2)."""
    truth_l = np.array([[2.0, 2.0], [4.0, 2.0]])
    poses = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [4.0, 0.0, 0.0]])
    b = GraphBuilder()
    F.add_prior(b, "se2", 0, poses[0], F.diag_noise([0.3, 0.3, 0.1]))
    for i in range(2):
        F.add_between(b, "se2", i, i + 1, np.array([2.0, 0.0, 0.0]),
                      F.diag_noise([0.2, 0.2, 0.1]))
    for pi, li in [(0, 0), (1, 0), (1, 1), (2, 1)]:
        bear = float(se2.bearing(_host(poses[pi]), _host(truth_l[li])))
        rng = float(se2.range_to(_host(poses[pi]), _host(truth_l[li])))
        b.add("br", F.bearing_range_2d_residual, ("se2", "point2"), 2,
              [pi, li], {"bearing": np.array(bear), "range": np.array(rng)},
              {"kind": "diag", "data": np.array([10.0, 5.0])})
    res = _optimize(b, {"se2": poses + 0.1,
                        "point2": truth_l + np.array([0.3, -0.2])}, dev)
    got_l = res.values["point2"].cpu().numpy()
    np.testing.assert_allclose(got_l, truth_l, atol=1e-6)
    say(f"planar SLAM: landmarks = {np.round(got_l, 4).tolist()}  OK")
    return got_l


def _rot_prior(xs, meas):
    (th,) = xs
    return so2.wrap(th - meas["prior"])


def simple_rotation(dev, say=print):
    """SimpleRotation.cpp: one Rot2 prior at 30 deg, the start at 20."""
    b = GraphBuilder()
    b.add("rp", _rot_prior, ("r1",), 1, [0], {"prior": np.deg2rad(30.0)},
          {"kind": "diag", "data": np.array([10.0])})
    res = _optimize(b, {"r1": np.array([[np.deg2rad(20.0)]])}, dev)
    got = float(res.values["r1"][0, 0])
    np.testing.assert_allclose(np.rad2deg(got), 30.0, atol=1e-8)
    say(f"simple rotation: {np.rad2deg(got):.4f} deg  OK")
    return got


def _resection(xs, meas):
    (pose,) = xs
    return cam_geo.project_point(pose, meas["point"], meas["cal"],
                                 "cal3_s2") - meas["measured"]


def camera_resectioning(dev, say=print):
    """CameraResectioning.cpp: the camera pose from 4 known world points
    and their pixels; the answer is the camera at (0, 0, 2) looking
    straight down at the x-y plane."""
    cal = np.array([1.0, 1.0, 0.0, 50.0, 50.0])
    R = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    truth = np.concatenate([R, np.array([[0.0], [0.0], [2.0]])], axis=1)
    pts = np.array([[10, 10, 0], [-10, 10, 0], [-10, -10, 0], [10, -10, 0]],
                   dtype=float)
    b = GraphBuilder()
    for p in pts:
        uv = cam_geo.project_point(_host(truth), _host(p), _host(cal)).numpy()
        b.add("resection", _resection, ("se3",), 2, [0],
              {"point": p, "cal": cal, "measured": uv},
              {"kind": "diag", "data": np.full(2, 2.0)})
    init = se3.retract(_host(truth), _host([0.1, -0.1, 0.05, 0.2, 0.1,
                                            -0.1])).numpy()
    res = _optimize(b, {"se3": init[None]}, dev)
    got = res.values["se3"][0].cpu().numpy()
    np.testing.assert_allclose(got, truth, atol=1e-6)
    say("camera resectioning: pose recovered  OK")
    return got


def _proj_cal(xs, meas):
    pose, cal, point = xs
    return cam_geo.project_point(pose, point, cal, "cal3_s2") - \
        meas["measured"]


def self_calibration(dev, say=print):
    """SelfCalibrationExample.cpp: ONE shared Cal3_S2 estimated jointly
    with every pose and point (the calibration is its own variable, shared
    by every projection factor)."""
    true_cal = np.array([320.0, 320.0, 0.0, 320.0, 240.0])
    d = 10.0
    pts = np.array([[d, d, d], [-d, d, d], [-d, -d, d], [d, -d, d],
                    [d, d, -d], [-d, d, -d], [-d, -d, -d], [d, -d, -d]])
    poses = []
    for i in range(6):
        th = 2 * np.pi * i / 8
        # varied heights: an all-coplanar rig leaves (fy, cy) near-degenerate
        eye = np.array([30 * np.cos(th), 30 * np.sin(th), 4.0 * (i % 3 - 1)])
        zc = -eye / np.linalg.norm(eye)
        xc = np.cross(zc, [0.0, 0.0, 1.0])
        xc /= np.linalg.norm(xc)
        Rm = np.stack([xc, np.cross(zc, xc), zc], axis=1)
        poses.append(np.concatenate([Rm, eye[:, None]], axis=1))
    poses = np.asarray(poses)

    b = GraphBuilder()
    b.add("prior_se3", F.make_prior_residual("se3"), ("se3",), 6, [0],
          {"prior": poses[0]}, {"kind": "diag", "data": np.full(6, 100.0)})
    b.add("prior_pt", F.make_prior_residual("point3"), ("point3",), 3, [0],
          {"prior": pts[0]}, {"kind": "diag", "data": np.full(3, 100.0)})
    for i in range(len(poses)):
        for j in range(len(pts)):
            uv = cam_geo.project_point(_host(poses[i]), _host(pts[j]),
                                       _host(true_cal)).numpy()
            b.add("projc", _proj_cal, ("se3", "cal5", "point3"), 2,
                  [i, 0, j], {"measured": uv}, {"kind": "unit"})
    manifolds.vector_space("cal5", 5)
    res = _optimize(b, {"se3": poses, "point3": pts,
                        "cal5": (true_cal * np.array([1.1, 1.1, 1, 1.02,
                                                      0.98]))[None]},
                    dev, iters=60)
    got_cal = res.values["cal5"][0].cpu().numpy()
    np.testing.assert_allclose(got_cal, true_cal, atol=1e-3)
    say(f"self-calibration: K = {np.round(got_cal, 3).tolist()}  OK")
    return got_cal


EXAMPLES = (odometry_example, localization_example, planar_slam_example,
            simple_rotation, camera_resectioning, self_calibration)


def run(device="cuda", say=print):
    """Every example in turn; returns {name: what it estimated}."""
    dev = config.device(device)
    out = {fn.__name__: fn(dev, say) for fn in EXAMPLES}
    say("TUTORIALS OK")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
