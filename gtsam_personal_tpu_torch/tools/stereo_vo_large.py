"""Stereo visual odometry on the reference's recorded VO dataset.

    python -m gtsam_personal_tpu_torch.tools.stereo_vo_large [--iters 30]
        [--device cuda]

JAX counterpart: examples/stereo_vo_large.py (the reference's
examples/StereoVOExample_large.cpp), with the same flags and printed
lines: 25 camera poses and 8189 stereo measurements (uL, uR, v) of ~4700
landmarks, each landmark initialized from its first sighting's
camera-frame triangulation, the first pose held by a tight prior, batch
LM with the dense solver (~14.3k tangent dimensions at full size: a 1.6
GB float64 Hessian). The three files are looked up with
slam/dataset.py:find_example_data; chip_smoke.py:write_vo_large writes
seeded stand-ins. The device is the card unless `--device cpu` asks for
the CPU; the problem is float64, as the JAX example's is under x64.

OK means: a finite error and an rms below 1 px per stereo coordinate.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import se3
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam.dataset import find_example_data
from gtsam_personal_tpu_torch.slam.factors import (make_prior_residual,
                                                   stereo_residual)


def load_vo():
    """(calibration [6] fx fy s u0 v0 b, pose rows [n, 17], factor rows
    [K, 8]): np.loadtxt of the three files, as the JAX example reads
    them."""
    return (np.loadtxt(find_example_data("VO_calibration.txt")),
            np.loadtxt(find_example_data("VO_camera_poses_large.txt")),
            np.loadtxt(find_example_data("VO_stereo_factors_large.txt")))


def first_sightings(l_id):
    """(index of each factor's landmark in the order of first appearance,
    the factor row of each landmark's first sighting), the JAX example's
    `lmap` and loop, without the loop."""
    _, first, inv = np.unique(l_id, return_index=True, return_inverse=True)
    order = np.argsort(first)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inv], first[order]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def build(device="cuda", dtype=torch.float64, say=print):
    """(graph, initial values, the file's poses [n, 3, 4]) of the
    example on `device`: the read, the landmarks' start and the
    factors."""
    dev = config.device(device)
    calib, rows, fac = load_vo()
    fx, fy, _, u0, v0, b = calib
    cal = np.array([fx, fy, u0, v0, b])     # stereo_residual layout
    pose_ids = rows[:, 0].astype(int)
    poses0 = rows[:, 1:].reshape(-1, 4, 4)[:, :3, :]     # wTc [3, 4]
    pix = np.empty(pose_ids.max() + 1, dtype=np.int64)
    pix[pose_ids] = np.arange(len(pose_ids))
    x_ix = pix[fac[:, 0].astype(int)]
    l_ix, first = first_sightings(fac[:, 1].astype(int))
    say(f"read {len(poses0)} poses, {len(fac)} stereo factors, "
        f"{len(first)} landmarks")
    # landmark initialization: first sighting's camera-frame triangulation
    # into the world (reference: transformFrom)
    l_init = se3.transform_from(torch.tensor(poses0[x_ix[first]]),
                                torch.tensor(fac[first, 5:8])).numpy()

    gb = GraphBuilder()
    gb.add("prior_se3", make_prior_residual("se3"), ("se3",), 6,
           [pix[pose_ids[0]]], {"prior": poses0[pix[pose_ids[0]]]},
           {"kind": "diag", "data": np.full(6, 1e6)})
    for i in range(len(fac)):
        gb.add("stereo", stereo_residual, ("se3", "point3"), 3,
               [x_ix[i], l_ix[i]], {"measured": fac[i, 2:5], "cal": cal},
               {"kind": "unit"})
    return (gb.build(device=dev, dtype=dtype),
            values_from_numpy({"se3": poses0, "point3": l_init},
                              device=dev, dtype=dtype), poses0)


def run(iters=30, device="cuda", dtype=torch.float64, say=print):
    """Returns a dict: 'error', 'iterations', 'rms', 'seconds', the
    'values' (the LM Result's), 'corrections' (mean and max pose position
    correction in m) and 'ok'."""
    dev = config.device(device)
    graph, init, poses0 = build(dev, dtype, say)
    K = graph.num_factors - 1
    _sync(dev)
    t0 = time.perf_counter()
    res = optimizers.optimize_lm(graph, init,
                                 optimizers.Params(max_iterations=iters))
    _sync(dev)
    dt = time.perf_counter() - t0
    rms = float(np.sqrt(2 * res.error / (3 * K)))
    say(f"final error {res.error:.2f} in {res.iterations} iterations, "
        f"{dt:.1f}s; rms {rms:.3f}px per stereo coordinate")
    d0 = np.linalg.norm(res.values["se3"][:, :, 3].cpu().numpy()
                        - poses0[:, :, 3], axis=1)
    say(f"pose position corrections: mean {d0.mean():.4f} m, "
        f"max {d0.max():.4f} m")
    ok = bool(np.isfinite(res.error) and rms < 1.0)
    say("STEREO-VO OK" if ok else "STEREO-VO FAIL")
    return {"error": res.error, "iterations": res.iterations, "rms": rms,
            "seconds": dt, "values": res.values,
            "corrections": (float(d0.mean()), float(d0.max())), "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return 0 if run(args.iters, args.device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
