"""Range-only SLAM on the recorded Plaza2 dataset, incrementally with ISAM2.

    python -m gtsam_personal_tpu_torch.tools.range_isam_plaza2 [--steps N]
        [--minK 150] [--incK 25] [--no-robust] [--device cuda]

JAX counterpart: examples/range_isam_plaza2.py (the reference's
examples/RangeISAMExample_plaza2.cpp), with the same flags and printed
lines: 4090 odometry steps (Plaza2_DR.txt: time, delta distance, delta
heading) and 1816 UWB ranges to 4 fixed beacons (Plaza2_TD.txt: time,
sender, beacon id, range), Tukey(15)-robust isotropic range noise, a batch
LM start once more than `minK` ranges are in, then one ISAM2 update per
more than `incK` new ranges. The files are looked up with
slam/dataset.py:find_example_data; chip_smoke.py:write_plaza2 writes
seeded stand-ins. The engine keeps the JAX example's parameters (the
Jacobi preconditioner, CG cut at its tolerance); `run(**engine)`
overrides ISAM2Params fields. The device is the card unless `--device
cpu` asks for the CPU; float64.

OK means: a finite final error below 5 per measurement.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import se2
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2, ISAM2Params
from gtsam_personal_tpu_torch.slam.dataset import find_example_data
from gtsam_personal_tpu_torch.slam.factors import (make_between_residual,
                                                   make_prior_residual,
                                                   range_2d_residual)

PRIOR_SIG = np.array([1.0, 1.0, np.pi])
ODO_SIG = np.array([0.05, 0.01, 0.1])
SIGMA_R = 100.0
POSE0 = np.array([-34.2086489999201, 45.3007639991120, np.pi - 2.021089])


def load_plaza2():
    """(DR rows [n, 3]: t, delta distance, delta heading; TD rows [K, 4]:
    t, sender, beacon id, range), np.loadtxt of the two files."""
    return (np.loadtxt(find_example_data("Plaza2_DR.txt")),
            np.loadtxt(find_example_data("Plaza2_TD.txt")))


def _diag(sig):
    return NoiseModel("diag", 1.0 / np.asarray(sig, dtype=np.float64))


def run(steps=None, min_k=150, inc_k=25, robust=True, device="cuda",
        dtype=torch.float64, say=print, **engine):
    """Returns a dict: 'isam' (the engine), 'batch' (the start's LM
    Result), 'error' (final), 'updates', 'beacons' {id: [2]}, 'seconds'
    and 'ok'. `engine` overrides fields of ISAM2Params."""
    dev = config.device(device)
    dr, td = load_plaza2()
    if steps:
        dr = dr[:steps]
    say(f"read {len(dr)} odometry entries, {len(td)} range triples")
    between, prior, rres = (make_between_residual("se2"),
                            make_prior_residual("se2"), range_2d_residual)
    odo_noise, prior_noise = _diag(ODO_SIG), _diag(PRIOR_SIG)
    range_noise = NoiseModel("diag", np.array([1.0 / SIGMA_R]),
                             "none" if not robust else "tukey",
                             None if not robust else np.array(15.0))

    rng = np.random.default_rng(42)
    landmarks = {}                  # beacon id -> point2 variable index
    poses = [POSE0]
    stage_odo, stage_rng = [], []   # host staging until the batch start
    k, K, isam, count_k, n_updates = 0, len(td), None, 0, 0
    t_start = time.perf_counter()
    for i in range(1, len(dr) + 1):
        t, dist, dhead = dr[i - 1]
        odom = np.array([dist, 0.0, dhead])
        pred = se2.compose(torch.tensor(poses[-1]),
                           torch.tensor(odom)).numpy()
        poses.append(pred)
        if isam is None:
            stage_odo.append((i - 1, i, odom))
        else:
            pi = isam.add_variable("se2", pred)
            isam.add_factor("odo", between, ("se2", "se2"), 3, [pi - 1, pi],
                            {"measured": odom}, odo_noise)
        while k < K and t >= td[k][0]:
            j, rng_m = int(td[k][2]), float(td[k][3])
            if j not in landmarks:
                landmarks[j] = len(landmarks)
                say(f"  beacon {j} first seen at t={t:.1f}")
                if isam is not None:
                    isam.add_variable("point2",
                                      rng.normal(scale=100.0, size=2))
            if isam is None:
                stage_rng.append((i, j, rng_m))
            else:
                isam.add_factor("range", rres, ("se2", "point2"), 1,
                                [i, landmarks[j]], {"range": np.array([rng_m])},
                                range_noise)
            k += 1
            count_k += 1

        if k > min_k and count_k > inc_k and isam is None:
            # batch start (reference: LevenbergMarquardtOptimizer)
            gb = GraphBuilder()
            gb.add("prior_se2", prior, ("se2",), 3, [0], {"prior": POSE0},
                   {"kind": "diag", "data": 1.0 / PRIOR_SIG})
            for a, c, o in stage_odo:
                gb.add("odo", between, ("se2", "se2"), 3, [a, c],
                       {"measured": o}, {"kind": "diag",
                                         "data": 1.0 / ODO_SIG})
            for pi_, j, r_ in stage_rng:
                gb.add("range", rres, ("se2", "point2"), 1,
                       [pi_, landmarks[j]], {"range": np.array([r_])},
                       {"kind": "diag", "data": np.array([1.0 / SIGMA_R]),
                        "robust": "tukey" if robust else "none",
                        "k": np.array(15.0)})
            # loose prior fixing the landmark gauge (reference looseNoise)
            for j, lj in landmarks.items():
                gb.add("lprior", make_prior_residual("point2"), ("point2",),
                       2, [lj], {"prior": np.zeros(2)},
                       {"kind": "diag", "data": np.full(2, 1.0 / 1000.0)})
            graph = gb.build(device=dev, dtype=dtype)
            init = values_from_numpy(
                {"se2": np.asarray(poses),
                 "point2": rng.normal(scale=100.0, size=(len(landmarks), 2))},
                device=dev, dtype=dtype)
            batch = optimizers.optimize_lm(
                graph, init, optimizers.Params(max_iterations=50))
            say(f"batch init at step {i} ({k} ranges): error "
                f"{batch.error:.2f}")
            # seed ISAM2 with the batch solution
            isam = ISAM2(ISAM2Params(**{"min_var_cap": 8192,
                                        "min_fac_cap": 8192, "dtype": dtype,
                                        **engine}), device=dev)
            for p in batch.values["se2"].cpu().numpy():
                isam.add_variable("se2", p)
            for ptv in batch.values["point2"].cpu().numpy():
                isam.add_variable("point2", ptv)
            isam.add_factor("prior_se2", prior, ("se2",), 3, [0],
                            {"prior": POSE0}, prior_noise)
            for a, c, o in stage_odo:
                isam.add_factor("odo", between, ("se2", "se2"), 3, [a, c],
                                {"measured": o}, odo_noise)
            for pi_, j, r_ in stage_rng:
                isam.add_factor("range", rres, ("se2", "point2"), 1,
                                [pi_, landmarks[j]], {"range": np.array([r_])},
                                range_noise)
            isam.update()
            count_k = 0
        elif isam is not None and count_k > inc_k:
            isam.update()
            poses[-1] = isam.estimate_at("se2", i)    # re-anchor
            n_updates += 1
            count_k = 0

    isam.update()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t_start
    err = isam.error()
    lm_pos = isam.estimate_array("point2")
    say(f"done: {len(dr)} poses, {len(landmarks)} beacons, "
        f"{n_updates + 1} ISAM2 updates, final error {err:.2f}, "
        f"{dt:.1f}s ({len(dr) / dt:.0f} poses/s)")
    for j, lj in sorted(landmarks.items()):
        say(f"  beacon {j}: ({lm_pos[lj][0]:8.2f}, {lm_pos[lj][1]:8.2f})")
    # the final whitened error per measurement is O(1) when ranges and
    # odometry are fused sanely
    n_meas = len(dr) * 3 + k
    ok = bool(np.isfinite(err) and err / n_meas < 5.0)
    say("PLAZA2 OK" if ok else "PLAZA2 FAIL")
    return {"isam": isam, "batch": batch, "error": err,
            "updates": n_updates + 1,
            "beacons": {j: lm_pos[lj] for j, lj in landmarks.items()},
            "seconds": dt, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="truncate the odometry stream (default: all)")
    ap.add_argument("--minK", type=int, default=150)
    ap.add_argument("--incK", type=int, default=25)
    ap.add_argument("--no-robust", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return 0 if run(a.steps, a.minK, a.incK, not a.no_robust,
                    a.device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
