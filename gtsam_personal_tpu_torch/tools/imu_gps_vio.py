"""IMU + GPS fusion from a recorded IMU/GPS file: the ISAM2 stream, or
batch LM over all fixes.

    python -m gtsam_personal_tpu_torch.tools.imu_gps_vio [--data FILE]
        [--n 100] [--batch] [--inner 3] [--cg 500] [--relin 0.01]
        [--bias-feedback] [--dtype float64] [--device cuda] [--truth F.npz]

JAX counterpart: examples/imu_gps_vio.py (the reference's
ImuFactorsExample.cpp with its imuParams(), in --use_isam mode and in batch
mode). The file is the reference's examples/Data/imuAndGPSdata.csv format:
rows 'i,N,E,D,qx,qy,qz,qw,vN,vE,vD' (initial state), '0,ax,ay,az,wx,wy,wz'
(IMU at 200 Hz, gravity removed) and '1,N,E,D,qx,qy,qz,qw' (GPS); the IMU
rows before a GPS row are that fix's segment. With no --data the
reference's file is looked up (slam/dataset.py:find_example_data).

Stream (the default): per GPS fix the segment is preintegrated in one
`preint_tangent` launch at zero bias (or the current bias estimate with
--bias-feedback), the new state starts at the prediction from the current
estimate, and the engine takes an ImuFactor, a bias random walk and a GPS
factor, then `--inner` updates (ISAM2 with the exact block-tridiagonal
`superchain:se3+vel3+imu_bias` preconditioner, CG to 1e-10, trust region
1.0), and four polishing updates at the end.

Batch (--batch): every segment preintegrated in ONE launch, the states
dead-reckoned from them at zero bias, then LM (60 iterations at most,
lambda0 1e-2) with the dense solver, as the JAX example, or `--solver
schur` (parts of at most --max-part timesteps). `--start gps` starts LM
at the fixes instead (positions at the fixes, velocities from their
differences, rotations dead-reckoned): over a long drive the dead
reckoning drifts by the double integral of the accelerometer bias's random
walk, and LM does not return from there.

The device is the card unless `--device cpu` asks for the CPU. SANE means
the mean position error is below 1 m, against the truth if --truth gives it
(an .npz with `positions` [n, 3] at the fixes), else against the GPS fixes.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.linear import schur
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.navigation import factors as nav
from gtsam_personal_tpu_torch.navigation import navstate
from gtsam_personal_tpu_torch.navigation import preintegration as pre
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2, ISAM2Params
from gtsam_personal_tpu_torch.slam import dataset
from gtsam_personal_tpu_torch.slam import factors as SF

DT = 0.005  # the fixed sample interval of the file format
DTYPES = {"float32": torch.float32, "float64": torch.float64}
PRIOR_POSE_SIGMAS = [0.01] * 3 + [0.5] * 3   # rad, m
PRIOR_VEL_SIGMA, BIAS_SIGMA, GPS_SIGMA = 0.1, 1e-3, 1.0
SUPERCHAIN = "superchain:se3+vel3+imu_bias"


def quat_to_rot(qx, qy, qz, qw):
    """Rotation matrix of a quaternion; identity for the all-zero
    quaternion of the reference file's first row (Eigen's behavior)."""
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    if n < 1e-12:
        return np.eye(3)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ])


def load_imu_gps_csv(path):
    """(init [10], segments [[n_k, 6]], gps [[7]]) of a file in the format
    above (reference: ImuFactorsExample.cpp:24-35)."""
    init = None
    segments, cur, gps = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if not parts or parts[0] == "":
                continue
            if parts[0] == "i":
                init = np.array([float(x) for x in parts[1:11]])
            elif parts[0] == "0":
                cur.append([float(x) for x in parts[1:7]])
            elif parts[0] == "1":
                segments.append(np.array(cur))
                cur = []
                gps.append(np.array([float(x) for x in parts[1:8]]))
    return init, segments, gps


def initial_state(init):
    """(pose0 [3, 4], vel0 [3]) of the file's initial-state row."""
    R0 = quat_to_rot(init[3], init[4], init[5], init[6])
    return np.concatenate([R0, init[:3][:, None]], axis=1), init[7:10]


def imu_params(*, device="cuda", dtype=torch.float64):
    """The reference example's imuParams() (ImuFactorsExample.cpp:85):
    MakeSharedD(0.0), gravity already removed from the recorded data; on
    the card unless `device` names another."""
    device = config.device(device)
    eye = torch.eye(3, device=device, dtype=dtype)
    return pre.PreintegrationParams(
        gravity=torch.zeros(3, device=device, dtype=dtype),
        accel_cov=(0.0003924 ** 2) * eye,
        gyro_cov=(0.000205689024915 ** 2) * eye,
        integration_cov=1e-8 * eye,
        bias_acc_cov=(0.004905 ** 2) * eye,
        bias_omega_cov=(0.000001454441043 ** 2) * eye)


def bias_between_residual(xs, meas):
    b_i, b_j = xs
    return b_j - b_i


def vel_prior_residual(xs, meas):
    return xs[0] - meas["prior"]


def bias_prior_residual(xs, meas):
    return xs[0] - meas["prior"]


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def integrate_segments(params, segments, bias_hat, *, device, dtype):
    """All segments in one kernel launch (padded with dt = 0 samples):
    bias_hat [6] or [S, 6] -> a PIM of S segments."""
    accs, gyros, dts = pre.pad_segments(segments, DT, device=device,
                                        dtype=dtype)
    b = torch.as_tensor(np.asarray(bias_hat, dtype=np.float64),
                        device=device, dtype=dtype)
    return pre.integrate_batch(params, b.expand(len(segments), 6),
                               accs, gyros, dts)


def dead_reckon(pims, params, pose0, vel0):
    """The states predicted one segment after another at zero bias from
    (pose0, vel0): poses [S + 1, 3, 4], velocities [S + 1, 3] as tensors
    where the PIMs live."""
    like = pims.zeta
    state = navstate.from_pose_vel(torch.as_tensor(pose0).to(like),
                                   torch.as_tensor(vel0).to(like))
    zero = like.new_zeros(6)
    states = [state]
    for k in range(pims.zeta.shape[0]):
        pim = pre.PIM(*(x[k] for x in pims))
        state = pre.predict(pim, params, state, zero)
        states.append(state)
    states = torch.stack(states)
    return navstate.pose_of(states), navstate.velocity(states)


def gps_start(poses, vel0, segments, gps):
    """The GPS-aided start: the positions of the dead-reckoned poses [S + 1,
    3, 4] replaced by the fixes, the velocities by the fixes' central
    differences in time (one-sided at the ends, vel0 at the start); the
    rotations stay dead-reckoned. Returns numpy (poses, velocities)."""
    poses = poses.copy()
    S = poses.shape[0] - 1
    pos = np.concatenate([poses[:1, :, 3], np.stack([g[:3] for g in
                                                     gps[:S]])])
    times = np.concatenate([[0.0], np.cumsum([len(s) * DT
                                              for s in segments[:S]])])
    poses[1:, :, 3] = pos[1:]
    vels = np.gradient(pos, times, axis=0)
    vels[0] = vel0
    return poses, vels


def build_batch_graph(pose0, vel0, pims, gps, params):
    """The batch problem's GraphBuilder: priors on the first state, and per
    segment k an ImuFactor (k, k+1, bias k), a bias random walk and a GPS
    factor on pose k+1 (the JAX example's factors, in its order)."""
    b = GraphBuilder()
    SF.add_prior(b, "se3", 0, pose0, SF.diag_noise(PRIOR_POSE_SIGMAS))
    b.add("vel_prior", vel_prior_residual, ("vel3",), 3, [0],
          {"prior": np.asarray(vel0)}, SF.diag_noise([PRIOR_VEL_SIGMA] * 3))
    b.add("bias_prior", bias_prior_residual, ("imu_bias",), 6, [0],
          {"prior": np.zeros(6)}, SF.diag_noise([BIAS_SIGMA] * 6))
    host = pre.PIM(*(x.detach().cpu() for x in pims))
    for k in range(pims.zeta.shape[0]):
        nav.add_imu_factor(b, k, k + 1, k, pre.PIM(*(x[k] for x in host)),
                           params)
        b.add("bias_walk", bias_between_residual, ("imu_bias", "imu_bias"),
              6, [k, k + 1], {}, SF.diag_noise([BIAS_SIGMA] * 6))
        nav.add_gps_factor(b, k + 1, gps[k][:3], SF.diag_noise([GPS_SIGMA] * 3))
    return b


def run_batch(pose0, vel0, segments, gps, n, *, device, dtype,
              solver="dense", max_part=128, start="dead_reckoning",
              verbose=False, say=print):
    """Batch LM over the first n fixes; returns a dict: 'result' (the LM
    Result), 'seconds' per step ('preintegrate', 'init', 'build', 'plan',
    'lm') and 'initial' (the error at the start).

    start "dead_reckoning" is the JAX example's; "gps" (`gps_start`) is for
    long drives, where the zero-bias dead reckoning drifts by the double
    integral of the accelerometer bias and LM does not come back from it."""
    dev = config.device(device)
    params = imu_params(device=dev, dtype=dtype)
    rec = {"seconds": {}}

    def timed(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        rec["seconds"][name] = time.perf_counter() - t0
        return out

    pims = timed("preintegrate", lambda: integrate_segments(
        params, segments[:n], np.zeros(6), device=dev, dtype=dtype))
    def initial():
        poses, vels = (x.cpu().numpy()
                       for x in dead_reckon(pims, params, pose0, vel0))
        if start == "gps":
            poses, vels = gps_start(poses, vel0, segments, gps)
        elif start != "dead_reckoning":
            raise ValueError(f"start {start!r}: 'dead_reckoning' or 'gps'")
        return values_from_numpy({"se3": poses, "vel3": vels,
                                  "imu_bias": np.zeros((n + 1, 6))},
                                 device=dev, dtype=dtype)
    values = timed("init", initial)
    graph = timed("build", lambda: build_batch_graph(
        pose0, vel0, pims, gps, params).build(device=dev, dtype=dtype))
    rec["initial"] = float(optimizers.graph_error(graph, values))
    plan = None
    if solver == "schur":
        plan = timed("plan", lambda: schur.make_plan(
            graph, values.counts(), max_part_size=max_part))
        say(f"partition: {plan.stats()}")
    res = timed("lm", lambda: optimizers.optimize_lm(
        graph, values, optimizers.Params(max_iterations=60,
                                         lambda_initial=1e-2, solver=solver,
                                         verbose=verbose), plan=plan))
    rec["result"] = res
    say(f"BATCH: {n} corrections, error {rec['initial']:.6g} -> "
        f"{res.error:.10g} in {res.iterations} iterations, converged="
        f"{res.converged}; seconds " + ", ".join(
            f"{k} {v:.3f}" for k, v in rec["seconds"].items()))
    return rec


def make_engine(pose0, vel0, n, *, cg=500, relin=0.01, refresh=10, device,
                dtype):
    """The stream's ISAM2 with the JAX example's settings (`refresh`: the
    engine's default precond_refresh, which the example keeps), its first
    state and priors added and one update taken."""
    isam = ISAM2(ISAM2Params(relinearize_threshold=relin, cg_maxiter=cg,
                             cg_tol=1e-10, min_var_cap=n + 1,
                             min_fac_cap=n + 1, precond=SUPERCHAIN,
                             precond_refresh=refresh, max_delta=1.0,
                             dtype=dtype), device=device)
    isam.add_variable("se3", pose0)
    isam.add_variable("vel3", vel0)
    isam.add_variable("imu_bias", np.zeros(6))
    isam.add_factor("prior_se3", SF.make_prior_residual("se3"), ["se3"], 6,
                    [0], {"prior": pose0},
                    NoiseModel("diag", 1.0 / np.asarray(PRIOR_POSE_SIGMAS)))
    isam.add_factor("prior_vel", vel_prior_residual, ["vel3"], 3, [0],
                    {"prior": vel0},
                    NoiseModel("diag", np.full(3, 1.0 / PRIOR_VEL_SIGMA)))
    isam.add_factor("prior_bias", bias_prior_residual, ["imu_bias"], 6, [0],
                    {"prior": np.zeros(6)},
                    NoiseModel("diag", np.full(6, 1.0 / BIAS_SIGMA)))
    isam.update()
    return isam


def add_fix(isam, k, segment, gps_k, params, bias_hat, prev_bias):
    """Fix k: preintegrate its segment (one kernel launch), start state
    k+1 at the prediction from the estimate of state k, add the IMU, bias
    walk and GPS factors."""
    dev, dtype = isam.device, isam.params.dtype
    pim = pre.PIM(*(x[0] for x in integrate_segments(
        params, [segment], bias_hat, device=dev, dtype=dtype)))
    state_i = navstate.from_pose_vel(
        torch.as_tensor(isam.estimate_at("se3", k), device=dev),
        torch.as_tensor(isam.estimate_at("vel3", k), device=dev))
    pred = pre.predict(pim, params, state_i,
                       torch.as_tensor(prev_bias, device=dev, dtype=dtype))
    isam.add_variable("se3", navstate.pose_of(pred).cpu().numpy())
    isam.add_variable("vel3", navstate.velocity(pred).cpu().numpy())
    isam.add_variable("imu_bias", prev_bias)
    meas = pre.pim_to_numpy(pim)
    cov = meas.pop("cov")
    info = np.linalg.inv(0.5 * (cov + cov.T) + 1e-12 * np.eye(9))
    meas["gravity"] = np.zeros(3)
    isam.add_factor("imu", nav.imu_residual,
                    ["se3", "vel3", "se3", "vel3", "imu_bias"], 9,
                    [k, k, k + 1, k + 1, k], meas,
                    NoiseModel("full", SF.full_info_noise(info)["data"]))
    isam.add_factor("bias_walk", bias_between_residual,
                    ["imu_bias", "imu_bias"], 6, [k, k + 1], {},
                    NoiseModel("diag", np.full(6, 1.0 / BIAS_SIGMA)))
    isam.add_factor("gps", nav.gps_residual, ["se3"], 3, [k + 1],
                    {"measured": gps_k[:3]},
                    NoiseModel("diag", np.full(3, 1.0 / GPS_SIGMA)))


def run_stream(pose0, vel0, segments, gps, n, *, inner=3, cg=500,
               relin=0.01, refresh=10, bias_feedback=False, polish=4,
               device, dtype, say=print):
    """The ISAM2 stream over the first n fixes; returns (engine, records):
    one record per fix, (seconds of the fix, [(seconds, ISAM2Result) of
    each update]), and the polishing updates' results last.

    `refresh` is the engine's precond_refresh: the preconditioner is
    rebuilt when a fix adds its state and then every `refresh` updates.
    With the default 10, updates 2 and 3 of a fix run CG with the
    preconditioner that update 1 built before it relinearized the moved
    states, and over a long stream CG climbs to its cap of 500 (the JAX
    example's engine does the same: it reaches the cap at fix 36 of a
    50-fix stand-in); `refresh=1` rebuilds it every update."""
    dev = config.device(device)
    params = imu_params(device=dev, dtype=dtype)
    isam = make_engine(pose0, vel0, n, cg=cg, relin=relin, refresh=refresh,
                       device=dev, dtype=dtype)
    prev_bias = np.zeros(6)
    recs = []
    for k in range(n):
        _sync(dev)
        t0 = time.perf_counter()
        add_fix(isam, k, segments[k], gps[k], params,
                prev_bias if bias_feedback else np.zeros(6), prev_bias)
        ups = []
        for _ in range(inner):
            t1 = time.perf_counter()
            res = isam.update()
            ups.append((time.perf_counter() - t1, res))
        prev_bias = isam.estimate_at("imu_bias", k + 1)
        recs.append((time.perf_counter() - t0, ups))
        if (k + 1) % 20 == 0:
            p = isam.estimate_at("se3", k + 1)[:, 3]
            say(f"  correction {k + 1:4d}: |pos - gps| = "
                f"{np.linalg.norm(p - gps[k][:3]):.3f} m")
    recs.append([isam.update() for _ in range(polish)])
    return isam, recs


def position_errors(est_pos, gps, n, truth=None):
    """|estimate - reference| [n] at fixes 1..n: against the truth's
    positions where given, else the GPS fixes."""
    ref = (np.asarray(truth)[:n] if truth is not None
           else np.stack([g[:3] for g in gps[:n]]))
    return np.linalg.norm(np.asarray(est_pos)[:n] - ref, axis=1)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default=None)
    ap.add_argument("--n", type=int, default=100, help="GPS fixes to use")
    ap.add_argument("--cg", type=int, default=500)
    ap.add_argument("--relin", type=float, default=0.01)
    ap.add_argument("--inner", type=int, default=3,
                    help="ISAM2 updates per GPS fix")
    ap.add_argument("--batch", action="store_true",
                    help="batch LM over all fixes instead of the stream")
    ap.add_argument("--solver", default="dense", choices=["dense", "schur"],
                    help="batch LM's linear solver")
    ap.add_argument("--max-part", type=int, default=128)
    ap.add_argument("--start", default="dead_reckoning",
                    choices=["dead_reckoning", "gps"],
                    help="batch LM's starting point")
    ap.add_argument("--bias-feedback", action="store_true",
                    help="preintegrate each segment at the current bias "
                    "estimate instead of zero")
    ap.add_argument("--truth", default=None,
                    help=".npz with 'positions' [n, 3] at the fixes")
    ap.add_argument("--dtype", default="float64", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = config.device(args.device)
    dtype = DTYPES[args.dtype]
    path = args.data or dataset.find_example_data("imuAndGPSdata.csv")
    t0 = time.perf_counter()
    init, segments, gps = load_imu_gps_csv(path)
    print(f"read {path}: {len(gps)} fixes, "
          f"{sum(len(s) for s in segments)} IMU samples "
          f"({time.perf_counter() - t0:.2f}s)")
    n = min(args.n, len(gps))
    pose0, vel0 = initial_state(init)
    truth = (np.load(args.truth)["positions"] if args.truth else None)
    t0 = time.perf_counter()
    if args.batch:
        rec = run_batch(pose0, vel0, segments, gps, n, device=dev,
                        dtype=dtype, solver=args.solver,
                        max_part=args.max_part, start=args.start,
                        verbose=True)
        est = rec["result"].values["se3"][1:n + 1, :, 3].cpu().numpy()
    else:
        isam, recs = run_stream(pose0, vel0, segments, gps, n,
                                inner=args.inner, cg=args.cg,
                                relin=args.relin,
                                bias_feedback=args.bias_feedback,
                                device=dev, dtype=dtype)
        wall = time.perf_counter() - t0
        ups = [u for _, us in recs[:-1] for u in us]
        print(f"\n{n} GPS corrections ({sum(len(s) for s in segments[:n])} "
              f"IMU samples) in {wall:.2f}s ({n / wall:.1f} fixes/s, "
              f"{1e3 * np.mean([t for t, _ in ups]):.2f} ms per update, "
              f"{np.mean([r.cg_iterations for _, r in ups]):.1f} CG "
              f"iterations per update)")
        print(f"final graph error: {isam.error():.6g}")
        est = isam.estimate_array("se3")[1:n + 1, :, 3]
    err = position_errors(est, gps, n, truth)
    what = "truth" if truth is not None else "GPS"
    print(f"position error vs {what}: mean {err.mean():.3f} m, max "
          f"{err.max():.3f} m (GPS sigma = {GPS_SIGMA} m)")
    ok = err.mean() < 1.0
    print("SANE" if ok else "DIVERGED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
