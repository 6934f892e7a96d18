"""IMU preintegration and GPS fusion on a simulated constant-twist drive:
a small batch solve.

    python -m gtsam_personal_tpu_torch.tools.imu_factors [--device cuda]

JAX counterpart: examples/imu_factors_example.py (the shape of the
reference's ImuFactorsExample.cpp / IMUKittiExampleGPS.cpp): 8 segments of
0.5 s at 200 Hz from a ConstantTwistScenario with noisy IMU samples, all
preintegrated in one kernel launch, an ImuFactor per segment on one shared
bias, a GPS factor on every second keyframe, and LM from perturbed states.
The random draws are the JAX example's, in its order.
"""

import argparse

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.navigation import factors as nav
from gtsam_personal_tpu_torch.navigation import preintegration as pre
from gtsam_personal_tpu_torch.navigation.scenario import ConstantTwistScenario
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam import factors as F


def vel_prior_residual(xs, meas):
    return xs[0] - meas["prior"]


def bias_prior_residual(xs, meas):
    return xs[0] - meas["prior"]


def run(*, device="cuda", dtype=torch.float64, say=print):
    """Build and solve; returns (LM Result, true poses [9, 3, 4])."""
    dev = config.device(device)
    params = pre.PreintegrationParams.make_shared_u(
        g=9.81, accel_sigma=0.02, gyro_sigma=0.002, device=dev, dtype=dtype)
    gravity = params.gravity.cpu().numpy()
    scen = ConstantTwistScenario(np.array([0.0, 0.0, 0.2]),
                                 np.array([1.5, 0.0, 0.0]))
    n_seg, seg_t, dt = 8, 0.5, 0.005
    nmeas = int(round(seg_t / dt))
    rng = np.random.default_rng(0)
    states = scen.nav_state(seg_t * np.arange(n_seg + 1)).numpy()
    w, v = scen.omega_b, scen.v_b

    b = GraphBuilder()
    F.add_prior(b, "se3", 0, states[0, :, :4], F.diag_noise([1e-3] * 6))
    b.add("vel_prior", vel_prior_residual, ("vel3",), 3, [0],
          {"prior": states[0, :, 4]}, F.diag_noise([1e-3] * 3))
    b.add("bias_prior", bias_prior_residual, ("imu_bias",), 6, [0],
          {"prior": np.zeros(6)}, F.diag_noise([1e-2] * 6))
    segs, gps = [], []
    for k in range(n_seg):
        R = scen.pose(seg_t * k + dt * np.arange(nmeas)).numpy()[:, :, :3]
        accs, gyros = [], []
        for s in range(nmeas):
            accs.append(np.cross(w, v) - R[s].T @ gravity
                        + rng.normal(scale=0.02, size=3))
            gyros.append(w + rng.normal(scale=0.002, size=3))
        segs.append(np.concatenate([accs, gyros], axis=1))
        if (k + 1) % 2 == 0:
            gps.append((k + 1, states[k + 1, :, 3]
                        + rng.normal(scale=0.05, size=3)))
    accs, gyros, dts = pre.pad_segments(segs, dt, device=dev, dtype=dtype)
    pims = pre.integrate_batch(params, accs.new_zeros((n_seg, 6)), accs,
                               gyros, dts)
    for k in range(n_seg):
        nav.add_imu_factor(b, k, k + 1, 0,
                           pre.PIM(*(x[k] for x in pims)), params)
        for j, pos in gps:
            if j == k + 1:
                nav.add_gps_factor(b, j, pos, F.diag_noise([0.05] * 3))
    graph = b.build(device=dev, dtype=dtype)

    poses = states[:, :, :4]
    poses_init = poses.copy()
    poses_init[1:, :, 3] += rng.normal(scale=0.3, size=(n_seg, 3))
    vels = states[:, :, 4]
    initial = values_from_numpy(
        {"se3": poses_init,
         "vel3": vels + rng.normal(scale=0.2, size=vels.shape),
         "imu_bias": np.zeros((1, 6))}, device=dev, dtype=dtype)
    say(f"initial error: {float(optimizers.graph_error(graph, initial))}")
    res = optimizers.optimize_lm(graph, initial)
    say(f"final error: {res.error:.4f} ({res.iterations} iters)")
    err = np.linalg.norm(res.values["se3"][:, :, 3].cpu().numpy()
                         - poses[:, :, 3], axis=1)
    say(f"position error per keyframe: {np.round(err, 4)}")
    say(f"estimated bias: {res.values['imu_bias'][0].cpu().numpy()}")
    return res, poses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
