"""Fixed-lag smoothing on a Pose2 stream.

    python -m gtsam_personal_tpu_torch.tools.fixed_lag_smoother
        [--steps 30] [--lag 2.0] [--dt 0.25] [--device cuda]

JAX counterpart: examples/fixed_lag_smoother.py (the reference's
examples/FLS_example.cpp): a platform at constant speed sends odometry
every `dt` seconds into a fixed-lag smoother with a `lag`-second window;
states older than the lag are marginalized into a dense prior on the
window's boundary (linear/marginal.py), so memory stays bounded while the
recent window stays batch-optimal. The end compares the newest estimates
with the full batch and prints FIXED-LAG OK below 1e-2. The device is the
card unless `--device cpu` asks for the CPU.
"""

import argparse

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import se2
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.fixed_lag import FixedLagSmoother
from gtsam_personal_tpu_torch.slam import factors as F

F64 = torch.float64


def run(steps=30, lag=2.0, dt=0.25, device="cuda", say=print):
    """Returns a dict: 'diff' (the newest three estimates against the full
    batch, max abs), 'ok', 'estimate' [steps, 3] and 'batch' [steps, 3]
    (numpy)."""
    dev = config.device(device)
    rng = np.random.default_rng(0)
    n = steps
    # the truth: 2 m/s with a gentle turn
    step = np.array([2.0 * dt, 0.0, 0.1 * dt])
    truth = np.zeros((n, 3))
    for i in range(1, n):
        truth[i] = se2.compose(torch.tensor(truth[i - 1]),
                               torch.tensor(step)).numpy()

    smoother = FixedLagSmoother(lag=lag,
                                params=optimizers.Params(max_iterations=8))
    all_b = GraphBuilder()          # the full batch, for the cross-check
    for i in range(n):
        b = GraphBuilder()
        ts = {("se2", i): i * dt}
        if i == 0:
            for gb in (b, all_b):
                F.add_prior(gb, "se2", 0, truth[0],
                            F.diag_noise([0.1, 0.1, 0.05]))
        else:
            meas = step + rng.normal(scale=[0.02, 0.02, 0.01])
            for gb in (b, all_b):
                F.add_between(gb, "se2", i - 1, i, meas,
                              F.diag_noise([0.05, 0.05, 0.02]))
        init = values_from_numpy({"se2": truth[: i + 1]}, device=dev,
                                 dtype=F64)
        smoother.update(b.build(device=dev, dtype=F64).batches, init, ts)
        if i % 8 == 0 and i > 0:
            est = smoother.estimate()["se2"].cpu().numpy()
            held = sum(v >= (i * dt) - lag
                       for v in smoother.timestamps.values())
            say(f"t={i * dt:5.2f}s: newest pose ({est[i][0]:6.2f}, "
                f"{est[i][1]:6.2f}, {est[i][2]:5.2f}), window holds {held} "
                f"states")

    batch = optimizers.optimize_lm(
        all_b.build(device=dev, dtype=F64),
        values_from_numpy({"se2": truth}, device=dev, dtype=F64),
        optimizers.Params(max_iterations=20))
    est = smoother.estimate()["se2"].cpu().numpy()
    want = batch.values["se2"].cpu().numpy()
    diff = float(np.abs(est[-3:] - want[-3:]).max())
    say(f"recent-window estimates vs full batch: max diff {diff:.5f}")
    ok = diff < 1e-2
    say("FIXED-LAG OK" if ok else "FIXED-LAG FAIL")
    return {"diff": diff, "ok": ok, "estimate": est, "batch": want}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lag", type=float, default=2.0)
    ap.add_argument("--dt", type=float, default=0.25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return 0 if run(args.steps, args.lag, args.dt, args.device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
