"""Smart (structureless) projection factors streamed into ISAM2.

    python -m gtsam_personal_tpu_torch.tools.isam2_smart_factor [--poses 12]
        [--landmarks 30] [--track-len 4] [--noise 0.002] [--device cuda]

JAX counterpart: examples/isam2_smart_factor.py (the reference's
ISAM2Example_SmartFactor.cpp): camera poses on a circle stream in with
noisy odometry; landmarks are never variables, each track's smart factor
(sfm/smart.py) eliminates its landmark inside the residual. The engine has
no factor removal, so a track's factor is added once, when its window of
T consecutive poses is complete. Two updates per pose, then a batch LM
over the same graph as the cross-check. The scene, the noise and the order
of the random draws are the JAX example's, so the same arguments give the
same problem.

OK means: the stream's error at most 1.10 times the batch error, no pose
more than 0.25 m from the batch solution, and a mean position error below
2 m (the JAX example's rule).
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import se3
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2, ISAM2Params
from gtsam_personal_tpu_torch.sfm.smart import make_smart_residual
from gtsam_personal_tpu_torch.slam.factors import (make_between_residual,
                                                   make_prior_residual)

PRIOR_SIGMAS = np.r_[np.full(3, 0.01), np.full(3, 0.03)]
ODO_SIGMA = 0.005
DELTA0 = np.array([0.02, -0.01, 0.03, 0.1, -0.1, 0.05])


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def make_scene(n_poses, n_landmarks, track_len, noise, seed=0):
    """(poses [n, 3, 4], tracks [(first pose, uv [T, 2])], odometry [n-1,
    6]) of the JAX example: a circle of radius 30 m looking inward,
    landmarks uniform in a 16 m cube, each seen by a window of T
    consecutive poses."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n_poses):
        th = 2 * np.pi * i / n_poses
        eye = np.array([30 * np.cos(th), 30 * np.sin(th),
                        2.0 * np.sin(2 * th)])
        zc = -eye / np.linalg.norm(eye)
        xc = np.cross(zc, [0.0, 0.0, 1.0])
        xc /= np.linalg.norm(xc)
        R = np.stack([xc, np.cross(zc, xc), zc], axis=1)
        poses.append(np.concatenate([R, eye[:, None]], axis=1))
    poses = np.asarray(poses)
    pts = rng.uniform(-8, 8, size=(n_landmarks, 3))
    T = track_len
    tracks = []
    for j in range(n_landmarks):
        i0 = int(rng.integers(0, n_poses - T + 1))
        pc = se3.transform_to(_t(poses[i0:i0 + T]), _t(pts[j])).numpy()
        uvs = [pc[t, :2] / pc[t, 2] + rng.normal(scale=noise, size=2)
               for t in range(T)]
        tracks.append((i0, np.asarray(uvs)))
    odo = (se3.local(_t(poses[:-1]), _t(poses[1:])).numpy()
           + np.stack([rng.normal(scale=ODO_SIGMA, size=6)
                       for _ in range(n_poses - 1)]))
    return poses, tracks, odo


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(n_poses=12, n_landmarks=30, track_len=4, noise=0.002, *,
        refine_iters=3, device="cuda", dtype=torch.float64, say=print,
        **engine):
    """Stream and batch cross-check; returns a dict: 'isam' (the engine),
    'batch' (the LM Result), 'n_smart', 'pos_err' (mean position error of
    the stream's estimate against the truth), 'dpos' (largest stream -
    batch position gap), 'update_s' (seconds of each update), 'ok'.
    `refine_iters` is the smart factor's Gauss-Newton steps of its
    triangulation (make_smart_residual's argument; the JAX example takes
    the default 3). `engine` overrides fields of ISAM2Params (the JAX
    example takes the defaults)."""
    dev = config.device(device)
    T = track_len
    poses, tracks, odo = make_scene(n_poses, n_landmarks, T, noise)
    odo_meas = se3.expmap(_t(odo)).numpy()
    smart_res = make_smart_residual(T, refine_iters=refine_iters)
    prior_res, odo_res = (make_prior_residual("se3"),
                          make_between_residual("se3"))
    smart_noise = NoiseModel("diag", np.full(2 * T, 1.0 / noise))
    odo_noise = NoiseModel("diag", np.full(6, 1.0 / ODO_SIGMA))
    prior_noise = NoiseModel("diag", 1.0 / PRIOR_SIGMAS)

    isam = ISAM2(ISAM2Params(dtype=dtype, **engine), device=dev)
    t0 = time.perf_counter()
    est_pose = se3.retract(_t(poses[0]), _t(DELTA0)).numpy()
    n_smart, update_s = 0, []
    for i in range(n_poses):
        isam.add_variable("se3", est_pose)
        if i == 0:
            isam.add_factor("prior_se3", prior_res, ("se3",), 6, [0],
                            {"prior": poses[0]}, prior_noise)
        else:
            isam.add_factor("odo", odo_res, ("se3", "se3"), 6, [i - 1, i],
                            {"measured": odo_meas[i - 1]}, odo_noise)
        for i0, uvs in tracks:
            if i0 + T - 1 == i:
                isam.add_factor(f"smart_T{T}", smart_res, ("se3",) * T,
                                2 * T, list(range(i0, i0 + T)), {"uv": uvs},
                                smart_noise)
                n_smart += 1
        if i > 0:
            for _ in range(2):          # a second GN pass, as visual_isam2
                _sync(dev)
                t1 = time.perf_counter()
                isam.update()
                _sync(dev)
                update_s.append(time.perf_counter() - t1)
            if i + 1 < n_poses:         # dead-reckon the next pose
                est_pose = se3.compose(_t(isam.estimate_at("se3", i)),
                                       _t(odo_meas[i])).numpy()
    wall = time.perf_counter() - t0
    est = isam.estimate_array("se3")
    pos_err = np.linalg.norm(est[:, :, 3] - poses[:, :, 3], axis=1)
    say(f"{n_poses} poses, {n_smart} smart factors (T={T}): mean position "
        f"error {pos_err.mean():.4f} m, {n_poses / wall:.1f} poses/s, "
        f"{1e3 * np.mean(update_s):.2f} ms per update")

    b = GraphBuilder()
    b.add("prior_se3", prior_res, ("se3",), 6, [0], {"prior": poses[0]},
          {"kind": "diag", "data": 1.0 / PRIOR_SIGMAS})
    for i in range(n_poses - 1):
        b.add("odo", odo_res, ("se3", "se3"), 6, [i, i + 1],
              {"measured": odo_meas[i]},
              {"kind": "diag", "data": np.full(6, 1.0 / ODO_SIGMA)})
    for i0, uvs in tracks:
        b.add(f"smart_T{T}", smart_res, ("se3",) * T, 2 * T,
              list(range(i0, i0 + T)), {"uv": uvs},
              {"kind": "diag", "data": np.full(2 * T, 1.0 / noise)})
    graph = b.build(device=dev, dtype=dtype)
    init = values_from_numpy(
        {"se3": se3.retract(_t(poses), _t(DELTA0)).numpy()}, device=dev,
        dtype=dtype)
    res = optimizers.optimize_lm(graph, init,
                                 optimizers.Params(max_iterations=30))
    err = isam.error()
    say(f"batch LM error {res.error:.6f} vs incremental {err:.6f}")
    dpos = np.linalg.norm(est[:, :, 3]
                          - res.values["se3"][:, :, 3].cpu().numpy(), axis=1)
    say(f"incremental vs batch: max pose diff {dpos.max():.4f} m")
    ok = bool(err < res.error * 1.10 + 1e-9 and dpos.max() < 0.25
              and pos_err.mean() < 2.0)
    say("ISAM2-SMART OK" if ok else "ISAM2-SMART FAIL")
    return {"isam": isam, "batch": res, "n_smart": n_smart,
            "pos_err": float(pos_err.mean()), "dpos": float(dpos.max()),
            "update_s": update_s, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--poses", type=int, default=12)
    ap.add_argument("--landmarks", type=int, default=30)
    ap.add_argument("--track-len", type=int, default=4)
    ap.add_argument("--noise", type=float, default=0.002,
                    help="unit-plane measurement sigma (~1 px at f = 500)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.poses, args.landmarks, args.track_len, args.noise,
              device=args.device)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
