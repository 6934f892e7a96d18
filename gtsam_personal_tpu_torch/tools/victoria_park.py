"""Victoria Park: the classic landmark-SLAM benchmark, batch-optimized.

    python -m gtsam_personal_tpu_torch.tools.victoria_park [--n N]
        [--iters 30] [--robust] [--device cuda]

JAX counterpart: examples/victoria_park.py, with the same flags and printed
lines. It mirrors the reference's load2D handling of victoria_park.txt
(gtsam/slam/dataset.cpp:301,465): ODOMETRY lines are Pose2 between factors
with their covariance's diagonal, LANDMARK lines local (x, y) sightings
turned into bearing-range factors with the reference's heuristic
(bearing std sqrt(v1 / 10), range std sqrt(v1)). Poses and landmarks share
the file's one id space; the landmarks are the ids odometry never touches.
Dead-reckoned start, batch LM with the partitioned Schur solver (parts of
at most 256 poses: ~21k tangent dimensions at full size). The file is
looked up with slam/dataset.py:find_example_data;
chip_smoke.py:write_victoria_park writes a seeded stand-in. The device is
the card unless `--device cpu` asks for the CPU; float64.

OK means: a finite error below 5 per measurement dimension.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import se2
from gtsam_personal_tpu_torch.linear.schur import make_plan
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam.dataset import find_example_data
from gtsam_personal_tpu_torch.slam.factors import (bearing_range_2d_residual,
                                                   make_between_residual,
                                                   make_prior_residual)


def load_victoria(path, n_limit=None):
    """The JAX example's load_victoria, its tuples as arrays and parsed by
    numpy, not line by line: (odometry {'ij' [n, 2], 'd' [n, 3], 'cov'
    [n, 6]}, sightings {'pj' [m, 2], 'xy' [m, 2], 'cov' [m, 3]}). With
    `n_limit`, the first n_limit odometry lines and the sightings from
    poses up to the largest id they touch."""
    with open(path) as f:
        lines = np.char.lstrip(np.array(f.read().splitlines()))
    odo = np.loadtxt(lines[np.char.startswith(lines, "ODOMETRY ")],
                     usecols=range(1, 12), ndmin=2)
    lmk = np.loadtxt(lines[np.char.startswith(lines, "LANDMARK ")],
                     usecols=range(1, 8), ndmin=2)
    if n_limit:
        odo = odo[:n_limit]
        lmk = lmk[lmk[:, 0] <= odo[:, :2].max()]
    return ({"ij": odo[:, :2].astype(np.int64), "d": odo[:, 2:5],
             "cov": odo[:, 5:11]},
            {"pj": lmk[:, :2].astype(np.int64), "xy": lmk[:, 2:4],
             "cov": lmk[:, 4:7]})


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(n=None, iters=30, robust=False, device="cuda", dtype=torch.float64,
        say=print):
    """Returns a dict: 'error', 'iterations', 'per_dim' (error per
    measurement dimension), 'seconds', 'values' and 'ok'."""
    dev = config.device(device)
    odo, lmk = load_victoria(find_example_data("victoria_park.txt"), n)
    pose_ids = np.unique(odo["ij"])
    keep = np.isin(lmk["pj"][:, 0], pose_ids)
    lmk = {k: v[keep] for k, v in lmk.items()}
    lm_ids, first, lix = np.unique(lmk["pj"][:, 1], return_index=True,
                                   return_inverse=True)
    pix = np.searchsorted(pose_ids, odo["ij"])
    n_odo, n_lmk = len(odo["ij"]), len(lix)
    say(f"victoria park: {len(pose_ids)} poses, {n_odo} odometry, "
        f"{n_lmk} sightings of {len(lm_ids)} landmarks")

    # dead-reckoning initialization along the odometry chain
    cur = {0: np.zeros(3)}
    for (a, b), d in zip(pix.tolist(), odo["d"]):
        cur[b] = se2.compose(torch.tensor(cur[a]), torch.tensor(d)).numpy()
    init_pose = np.zeros((len(pose_ids), 3))
    for i, p in cur.items():
        init_pose[i] = p

    gb = GraphBuilder()
    gb.add("prior_se2", make_prior_residual("se2"), ("se2",), 3, [0],
           {"prior": np.zeros(3)}, {"kind": "diag", "data": np.full(3, 1e3)})
    # cov upper-tri (xx, xy, xt, yy, yt, tt) -> diagonal sigmas
    sig = np.sqrt(np.maximum(odo["cov"][:, [0, 3, 5]], 1e-12))
    between = make_between_residual("se2")
    for k in range(n_odo):
        gb.add("odo", between, ("se2", "se2"), 3, pix[k],
               {"measured": odo["d"][k]}, {"kind": "diag",
                                          "data": 1.0 / sig[k]})
    xy = lmk["xy"]
    bear, rng = np.arctan2(xy[:, 1], xy[:, 0]), np.linalg.norm(xy, axis=1)
    v1 = lmk["cov"][:, 0]
    w = np.stack([1.0 / np.sqrt(v1 / 10.0), 1.0 / np.sqrt(v1)], 1)
    lpix = np.searchsorted(pose_ids, lmk["pj"][:, 0])
    for k in range(n_lmk):
        noise = {"kind": "diag", "data": w[k]}
        if robust:
            noise["robust"] = "huber"
            noise["k"] = np.array(1.345)
        gb.add("br", bearing_range_2d_residual, ("se2", "point2"), 2,
               [lpix[k], lix[k]],
               {"bearing": np.array(bear[k]), "range": np.array(rng[k])},
               noise)
    init_lm = se2.transform_from(torch.tensor(init_pose[lpix[first]]),
                                 torch.tensor(xy[first])).numpy()
    graph = gb.build(device=dev, dtype=dtype)
    init = values_from_numpy({"se2": init_pose, "point2": init_lm},
                             device=dev, dtype=dtype)

    _sync(dev)
    t0 = time.perf_counter()
    # the dense solver would form a 3.5 GB Hessian at full size: the
    # partitioned Schur solver is exact at bounded memory
    plan = make_plan(graph, {"se2": len(pose_ids), "point2": len(lm_ids)},
                     max_part_size=256)
    res = optimizers.optimize_lm(graph, init,
                                 optimizers.Params(max_iterations=iters,
                                                   solver="schur"),
                                 plan=plan)
    _sync(dev)
    dt = time.perf_counter() - t0
    n_meas = 3 * (n_odo + 1) + 2 * n_lmk
    say(f"final error {res.error:.2f} in {res.iterations} iterations, "
        f"{dt:.1f}s; {res.error / n_meas:.4f} per measurement dim")
    ok = bool(np.isfinite(res.error) and res.error / n_meas < 5.0)
    say("VICTORIA-PARK OK" if ok else "VICTORIA-PARK FAIL")
    return {"error": res.error, "iterations": res.iterations,
            "per_dim": res.error / n_meas, "seconds": dt,
            "values": res.values, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=None,
                    help="truncate to the first N odometry edges")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--robust", action="store_true",
                    help="Huber on the landmark sightings")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return 0 if run(args.n, args.iters, args.robust, args.device)["ok"] \
        else 1


if __name__ == "__main__":
    raise SystemExit(main())
