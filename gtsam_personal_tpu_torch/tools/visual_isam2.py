"""Incremental visual SLAM (structure from motion) with the ISAM2 engine.

    python -m gtsam_personal_tpu_torch.tools.visual_isam2 [--poses 8]
        [--points 8] [--pixel-sigma 1.0] [--seed 0] [--prealloc 0]
        [--device cuda]

JAX counterpart: examples/visual_isam2.py (the reference's
examples/VisualISAM2Example.cpp), with the same flags and printed lines: a
rig of poses on a circle observes the 8 corners of a cube (or seeded
points) through projection factors with a Cal3_S2(50, 50, 0, 50, 50)
camera; each new pose streams its factors into ISAM2, three updates a
pose, and a batch LM on the same graph is the cross-check. The pose
prior's sigmas are the example's, 0.3 rad and 0.1 m (ROADMAP queue 3
C3). The engine keeps the example's parameters; `run(**engine)` overrides
ISAM2Params fields. The device is the card unless `--device cpu` asks
for the CPU; float64.

OK means: the stream's error at most 1.05 times the batch error (plus
1e-6) and a mean pose position error below 3 m.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import cameras, se3
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2, ISAM2Params
from gtsam_personal_tpu_torch.slam.factors import (make_prior_residual,
                                                   projection_residual)

CAL = np.array([50.0, 50.0, 0.0, 50.0, 50.0])   # Cal3_S2(50, 50, 0, 50, 50)
# (rot 0.3 rad, trans 0.1 m): the reference example's code, whose own
# comment has the two swapped (ROADMAP queue 3 C3)
POSE_PRIOR_SIGMAS = np.r_[np.full(3, 0.3), np.full(3, 0.1)]
POINT_PRIOR_SIGMA = 0.1
DELTA_POSE = np.array([-0.1, 0.2, 0.25, 0.05, -0.10, 0.20])   # (w, v)
DELTA_POINT = np.array([-0.25, 0.20, 0.15])


def make_scene(n_poses=8, n_points=8, radius=30.0, height=0.0, seed=0):
    """(poses [n, 3, 4], points [m, 3]): the cube's corners (or m seeded
    points) and a circle of cameras looking at the origin (the
    reference's SFMdata.h createPoints / createPoses)."""
    rng = np.random.default_rng(seed)
    if n_points == 8:
        d = 10.0
        pts = np.array([[d, d, d], [-d, d, d], [-d, -d, d], [d, -d, d],
                        [d, d, -d], [-d, d, -d], [-d, -d, -d], [d, -d, -d]])
    else:
        pts = rng.uniform(-10, 10, size=(n_points, 3))
    th = 2 * np.pi * np.arange(n_poses) / n_poses
    eye = np.stack([radius * np.cos(th), radius * np.sin(th),
                    np.full(n_poses, height)], 1)
    zc = -eye / np.linalg.norm(eye, axis=1, keepdims=True)
    xc = np.cross(zc, [0.0, 0.0, 1.0])
    xc /= np.linalg.norm(xc, axis=1, keepdims=True)
    R = np.stack([xc, np.cross(zc, xc), zc], axis=2)   # wRc columns
    return np.concatenate([R, eye[:, :, None]], axis=2), pts


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(poses=8, points=8, pixel_sigma=1.0, seed=0, prealloc=0,
        device="cuda", dtype=torch.float64, say=print, **engine):
    """Returns a dict: 'isam' (the engine), 'batch' (the LM Result),
    'error' (the stream's), 'pos_err' and 'pt_err' (mean errors against the
    truth), 'dpos' and 'dpt' (largest stream - batch gaps), 'seconds' (of
    the stream), 'update_s' (of each update) and 'ok'."""
    dev = config.device(device)
    rng = np.random.default_rng(seed)
    truth, pts = make_scene(poses, points, seed=seed)
    uv = cameras.project_point(torch.tensor(truth)[:, None],
                               torch.tensor(pts)[None],
                               torch.tensor(CAL)).numpy()
    meas = uv + rng.normal(scale=pixel_sigma, size=uv.shape)   # [n, m, 2]
    noisy = se3.retract(torch.tensor(truth),
                        torch.tensor(DELTA_POSE)).numpy()

    params = (dict(min_var_cap=prealloc, min_fac_cap=4 * prealloc)
              if prealloc else {})
    isam = ISAM2(ISAM2Params(dtype=dtype, **{**params, **engine}),
                 device=dev)
    px_noise = NoiseModel("diag", np.full(2, 1.0 / pixel_sigma))
    pose_prior = NoiseModel("diag", 1.0 / POSE_PRIOR_SIGMAS)
    point_prior = NoiseModel("diag", np.full(3, 1.0 / POINT_PRIOR_SIGMA))
    prior_se3, prior_p3 = (make_prior_residual("se3"),
                           make_prior_residual("point3"))

    update_s = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(poses):
        pi = isam.add_variable("se3", noisy[i])
        if i == 0:
            isam.add_factor("prior_se3", prior_se3, ("se3",), 6, [pi],
                            {"prior": truth[0]}, pose_prior)
            for j in range(points):
                isam.add_variable("point3", pts[j] + DELTA_POINT)
            isam.add_factor("prior_point3", prior_p3, ("point3",), 3, [0],
                            {"prior": pts[0]}, point_prior)
        for j in range(points):
            isam.add_factor("proj", projection_residual, ("se3", "point3"),
                            2, [pi, j], {"measured": meas[i, j], "cal": CAL},
                            px_noise)
        if i == 0:
            continue           # two views before the map is solvable
        # three bounded-cost updates a pose, as the JAX example (the
        # reference calls update() again for extra GN refinement,
        # VisualISAM2Example.cpp:140)
        for _ in range(3):
            t1 = time.perf_counter()
            isam.update()
            _sync(dev)
            update_s.append(time.perf_counter() - t1)
        pe = np.linalg.norm(isam.estimate_at("se3", pi)[:, 3]
                            - truth[i][:, 3])
        say(f"step {i}: err {isam.error():10.4f}  "
            f"newest-pose position error {pe:.4f} m")
    _sync(dev)
    dt = time.perf_counter() - t0

    est_pose, est_pt = isam.estimate_array("se3"), \
        isam.estimate_array("point3")
    pos_err = np.linalg.norm(est_pose[:, :, 3] - truth[:, :, 3], axis=1)
    pt_err = np.linalg.norm(est_pt - pts, axis=1)
    say(f"final: mean pose position error {pos_err.mean():.4f} m, "
        f"mean landmark error {pt_err.mean():.4f} m, "
        f"{poses / dt:.1f} poses/s")

    # cross-check against batch LM on the same graph
    gb = GraphBuilder()
    gb.add("prior_se3", prior_se3, ("se3",), 6, [0], {"prior": truth[0]},
           {"kind": "diag", "data": 1.0 / POSE_PRIOR_SIGMAS})
    gb.add("prior_point3", prior_p3, ("point3",), 3, [0], {"prior": pts[0]},
           {"kind": "diag", "data": np.full(3, 1.0 / POINT_PRIOR_SIGMA)})
    for i in range(poses):
        for j in range(points):
            gb.add("proj", projection_residual, ("se3", "point3"), 2, [i, j],
                   {"measured": meas[i, j], "cal": CAL},
                   {"kind": "diag", "data": np.full(2, 1.0 / pixel_sigma)})
    graph = gb.build(device=dev, dtype=dtype)
    init = values_from_numpy({"se3": noisy, "point3": pts + DELTA_POINT},
                             device=dev, dtype=dtype)
    batch = optimizers.optimize_lm(graph, init,
                                   optimizers.Params(max_iterations=30))
    err = isam.error()
    say(f"batch LM error {batch.error:.6f} vs incremental {err:.6f}")
    # the binding rule is energy parity: with only a pose-0 and point-0
    # prior the cost is near-flat along gauge directions, so two solutions
    # at the same energy can sit ~1 m apart; the parameter gap is advisory
    dpos = np.linalg.norm(est_pose[:, :, 3]
                          - batch.values["se3"][:, :, 3].cpu().numpy(),
                          axis=1)
    dpt = np.linalg.norm(est_pt - batch.values["point3"].cpu().numpy(),
                         axis=1)
    say(f"incremental vs batch: max pose diff {dpos.max():.4f} m, "
        f"max landmark diff {dpt.max():.4f} m")
    ok = bool(err < batch.error * 1.05 + 1e-6 and pos_err.mean() < 3.0)
    say("VISUAL-ISAM2 OK" if ok else "VISUAL-ISAM2 FAIL")
    return {"isam": isam, "batch": batch, "error": err,
            "pos_err": float(pos_err.mean()), "pt_err": float(pt_err.mean()),
            "dpos": float(dpos.max()), "dpt": float(dpt.max()),
            "seconds": dt, "update_s": update_s, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=8)
    ap.add_argument("--points", type=int, default=8)
    ap.add_argument("--pixel-sigma", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prealloc", type=int, default=0,
                    help="pre-size the engine's capacities")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return 0 if run(a.poses, a.points, a.pixel_sigma, a.seed, a.prealloc,
                    a.device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
