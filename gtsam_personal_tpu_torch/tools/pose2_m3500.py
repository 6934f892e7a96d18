"""M3500-shape Manhattan-world Pose2SLAM.

    python -m gtsam_personal_tpu_torch.tools.pose2_m3500 [--n 3500]
        [--seed 42] [--solver schur|pcg|dense] [--device cuda]

JAX counterpart: examples/pose2_m3500.py, with the same flags and printed
lines (its `--platform` is `--device` here). The Olson M3500 file is not
shipped in the reference's data; slam/manhattan.py generates a problem of
its statistics (3500 poses, grid odometry, proximity loop closures).
Batch LM (at most 50 iterations, lambda0 1e-4, PCG to 1e-10 or 500
iterations) with the partitioned Schur solver (parts of at most 256
poses), PCG or the dense solver, then the aligned ATE against the truth.
The device is the card unless `--device cpu` asks for the CPU; float64.

OK means: LM converged and the ATE rmse is below 0.5 m.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.linear.schur import make_plan
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam import manhattan, metrics


def run(n=3500, seed=42, solver="schur", device="cuda", dtype=torch.float64,
        say=print):
    """Returns a dict: the LM 'result', 'seconds', 'ate' and 'init_ate'
    (rmse, m) and 'ok'. LM's verbose lines go to stdout, as the JAX
    example's do."""
    dev = config.device(device)
    graph, initial, truth = manhattan.make_manhattan(n, seed=seed,
                                                     device=dev, dtype=dtype)
    say(f"M3500-shape problem: {n} poses, {graph.num_factors} factors")
    plan = make_plan(graph, {"se2": n}, max_part_size=256) \
        if solver == "schur" else None
    params = optimizers.Params(solver=solver, max_iterations=50,
                               pcg_maxiter=500, pcg_tol=1e-10,
                               lambda_initial=1e-4, verbose=True)
    t0 = time.time()
    res = optimizers.optimize_lm(graph, initial, params, plan=plan)
    wall = time.time() - t0

    init_ate = metrics.ate(initial["se2"][:, :2].cpu().numpy(),
                           truth[:, :2], align=True)["rmse"]
    ate = metrics.ate(res.values["se2"][:, :2].cpu().numpy(), truth[:, :2],
                      align=True)["rmse"]
    say(f"\nconverged={res.converged} iters={res.iterations} "
        f"error={res.error:.4f} wall={wall:.1f}s")
    say(f"ATE RMSE: odometry init {init_ate:.3f} m -> optimized "
        f"{ate:.4f} m")
    ok = bool(res.converged and ate < 0.5)
    say("PARITY OK" if ok else "PARITY FAIL")
    return {"result": res, "seconds": wall, "ate": ate,
            "init_ate": init_ate, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=3500)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--solver", default="schur")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    return 0 if run(a.n, a.seed, a.solver, a.device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
