#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gtsam_personal_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. require CUDA (there is no CPU fallback) and print the card's name and
     power limit as nvidia-smi reports them;
  2. build the CUDA kernel from csrc/ with nvcc for sm_90a (set-up time);
  3. hold the kernel against its plain torch version on the card at
     P = 156000 and P = 77 in float64 and float32, and time both, and
     `torch.linalg.solve` on the same blocks as [P, 3, 3], at P = 156000 in
     float32: the device time of each from a `torch.profiler` pass over 200
     calls (the `ms` figures of the kernels record), and the time per call
     of the host's launch path with CUDA events around 200 calls;
  4. one LM step and 5 LM iterations on a 29-camera problem in float64, on
     the card and on the CPU: the two must agree;
  5. the main path at full size: bundle adjustment LM on the skewed
     Ladybug-1723-scale synthetic problem (1723 cameras, 156k landmarks,
     ~529k observations) in float32, lambda0 = 1e-3, 2 CG iterations, one
     warm-up run of 10 iterations, then 10 timed iterations, under the
     gates of bench.py: the error is finite, it decreases, and the rms
     reprojection error is below 1.3 px;
  6. the pose-graph path at a small size in float64 (300-pose Manhattan
     world, parts of at most 32 poses): one partitioned-Schur solve and 6 LM
     iterations on the card and on the CPU must agree, and on the card the
     partitioned solve must equal the dense solve; then a 40-pose SE(3)
     graph through the dense solver, float64 card against CPU and float32
     on the card;
  7. the pose-graph path at full size: batch LM on a 10000-pose Manhattan
     world with loop closures from its odometry-composed start, partitioned
     Schur solver with parts of at most 256 poses, lambda0 = 1e-5, 12
     iterations (the values of bench.py's pose-graph metric), in float32
     and in float64, one warm-up run and three timed runs each; gates: the error is finite and
     decreases, the same run in float64 ends within 1e-3 relative of the
     float32 error, and the aligned ATE rmse against the truth is below
     0.5 m;
  8. the chain preconditioner's numerics on the card: the chain_factorize
     kernel against its plain version (a Python loop) on blocks harvested
     from linearized graphs, d = 3 (a 256-pose Manhattan world) and d = 6
     (a 256-pose SE(3) chain) at capacity 256, d = 4 and 15 on seeded SPD
     chains at capacity 64, in float64 (1e-10 of the largest entry) and
     float32 (1e-3), and d = 3 at full length (capacity 16384, the 10000
     poses of phase 7's graph); then factorize + chain_apply in float32
     against float64 at that length (relative error of the applied gradient
     below 1e-3: what a TF32 product in the chain would break); device time
     of the kernel at capacity 16384, d = 3 and 6 (CUDA events around 20
     launches, and a `torch.profiler` pass beside them), and of chain_apply
     with its device events per call (`torch.profiler`);
  9. ISAM2 at a small size in float64: a 200-pose Manhattan stream, one
     update per measurement, `chain:se2`, CG run to convergence, on the card
     and on the CPU: the same rows relinearized in every update, CG
     iteration counts within 2, estimates to 1e-8, error to 1e-9 relative;
     then the 20 oldest poses marginalized out and two more updates, same
     comparison; then checkpointing on the card: the same stream saved
     with save_isam2 at update 100, loaded back onto the card and streamed
     on ends within 1e-12 of the uninterrupted engine, and an lm_run of 6
     iterations on a 300-pose graph equals 3 iterations, save_lm_carry,
     load_lm_carry and 3 more (lambda equal, error and values to 1e-12);
 10. the ISAM2 stream at full size in float32: the 10000 poses and 18089
     factors of phase 7's graph through the engine with the defaults of
     examples/isam2_city10000.py (40 CG iterations, tolerance 1e-3,
     relinearization threshold 0.01, `chain:se2`, capacities set for the
     whole stream), an update every 10 measurements up to pose
     ISAM_SWITCH_POSE and after every measurement from there to the end,
     then six polishing updates; gates: the error is finite and at most 1.05
     times the float64 batch optimum of phase 7, the aligned ATE rmse is
     below 0.5 m, and the chain_factorize kernel was launched;
 11. the 2D file path at city10000 scale (tools/pose_graph_g2o.py's steps):
     phase 7's 10000-pose graph written with write_g2o_2d and read back
     with load_2d onto the card (its error at the written values equal to
     the original's to 1e-9 relative, float64; read as "g2o", since
     noise_format="auto" takes the writer's diagonal information for a
     covariance, whose error is printed beside it),
     lago_init_2d on the card (20000 unknowns: the PCG branch),
     make_plan(max_part_size=128) and optimize_lm(solver="schur",
     max_iterations=30) in float32 and float64; gates: the error decreases,
     float32 ends within 1e-3 relative of float64, float64 within 1% of
     phase 7's float64 optimum, aligned ATE rmse < 0.5 m;
 12. the 3D file path at the shape of the reference's sphere2500.txt: a
     seeded stand-in (2500 poses, 50 rings of 50 on a sphere of radius
     50 m, 2499 odometry edges and 2450 closures to the ring below,
     measurements the true relative pose composed with Exp(xi),
     xi ~ N(0, diag(0.01^2 I, 0.05^2 I)), information the inverse of that
     covariance, vertices the composed noisy odometry) written as
     VERTEX_SE3:QUAT / EDGE_SE3:QUAT, then load_3d, chordal_init_f64,
     make_plan(max_part_size=128) and optimize_lm(solver="schur",
     max_iterations=30) in float32 and float64 on the card, and the device
     chordal_init in float32 and float64 (the errors it reaches are
     printed, not gated); gates: chordal error < odometry error, LM error
     decreasing, float32 within 1e-3 relative of float64, float64 within
     20% of the optimum's expectation 7350 (half of 6 x 4950 - 6 x 2500),
     SE(3)-aligned ATE rmse against the truth below SPHERE_ATE_BOUND; the
     result written with write_g2o_3d(fmt="quat") and read back has the
     final error to 1e-9 (float64);
 13. factor breadth on the card: for every name residual_by_name knows
     (slam/factors.py:residual_names), 4096 seeded factors
     (tools/factor_samples.py) linearized on the card and on the CPU in
     float64: residuals and Jacobians agree to rtol 1e-10 (with an atol of
     1e-10 times the largest entry).

The last two lines are a JSON record of the kernels ({"kernels": [...]},
each with the launch count from its main path: the timed run of phase 5,
the stream of phase 10) and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config, native
from gtsam_personal_tpu_torch.core.graph import FactorBatch, GraphBuilder
from gtsam_personal_tpu_torch.core.values import (Layout, Values,
                                                  values_from_numpy)
from gtsam_personal_tpu_torch.geometry import se3
from gtsam_personal_tpu_torch.linear import schur, solvers
from gtsam_personal_tpu_torch.linear.linearize import (linearize,
                                                       linearize_batch)
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import isam2, optimizers
from gtsam_personal_tpu_torch.ops import _build, chain
from gtsam_personal_tpu_torch.ops.block_solve import (
    landmark_block_solve, landmark_block_solve_ref)
from gtsam_personal_tpu_torch.ops.chain import chain_factorize
from gtsam_personal_tpu_torch.sfm import ba, ba_pack, synthetic
from gtsam_personal_tpu_torch.slam import (dataset, factors as F, initialize,
                                           manhattan, metrics)
from gtsam_personal_tpu_torch.tools import factor_samples, profile_isam2
from gtsam_personal_tpu_torch.utils import serialization
from gtsam_personal_tpu_torch.tools.profile_isam2 import (
    ISAM_N, ISAM_PARAMS, ISAM_UPDATE_EVERY)
from gtsam_personal_tpu_torch.tools.profile_pose_graph import (
    POSE_ITERS, POSE_LAM0, POSE_N, POSE_PART, device_ms_per_call)

KERNEL_SOURCE = "gtsam_personal_tpu_torch/csrc/landmark_block_solve.cu"
KERNEL_REPLACES = "gtsam_personal_tpu/ops/pallas_kernels.py:23"
P_FULL = 156000
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# arithmetic of one block solve: 3x3 cofactors, determinant, reciprocal,
# scaled inverse (6 unique entries) and the product with t
BLOCK_SOLVE_FLOPS = 56
CHAIN_SOURCE = "gtsam_personal_tpu_torch/csrc/chain_factorize.cu"
CHAIN_REPLACES = "gtsam_personal_tpu/nonlinear/isam2.py:904"
CHAIN_CAP = 16384           # the capacity of the 10000-pose stream
CHAIN_LAM = 1e-6            # ISAM2Params.lam
# kernel against plain version, relative to the largest entry: the kernel
# inverts by Gauss-Jordan without pivoting and with fused multiply-adds,
# torch.linalg.inv by pivoted LU, and the difference compounds along the chain
CHAIN_RTOL = {torch.float64: 1e-10, torch.float32: 1e-3}
# phase 10 updates after every measurement from this pose on (the last 970
# or so of the 18088 measurements), and every ISAM_UPDATE_EVERY measurements
# before it: at about 0.1 s an update, more would not fit the script's time
ISAM_SWITCH_POSE = 9500
# phase 12: the stand-in of sphere2500.txt and its gates
SPHERE_RINGS, SPHERE_PER_RING, SPHERE_RADIUS = 50, 50, 50.0
SPHERE_SIGMAS = [0.01] * 3 + [0.05] * 3     # rad, m; tangent (omega, v)
SPHERE_OPTIMUM = 0.5 * (6 * 4950 - 6 * 2500)
# the aligned ATE rmse bound: the float64 run of the phase on the CPU ends
# at 0.1041 m (float32 the same), and the bound leaves half of that again
SPHERE_ATE_BOUND = 0.15
BREADTH_K = 4096


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _blocks(P, lam, dtype, dev, seed):
    """Random SPD landmark blocks [9, P], right-hand sides [3, P] and lam."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(P, 2, 3))
    H = np.einsum("pij,pik->pjk", A, A) + 0.1 * np.eye(3)
    t = rng.normal(size=(3, P))

    def d(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=dev)
    return d(H.reshape(P, 9).T), d(t), d(lam)


def _time_ms(fn, n=200):
    """Mean milliseconds per call over n calls, by CUDA events: for a
    kernel of a few microseconds this is the host's launch path, not the
    kernel."""
    for _ in range(10):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[2] built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in path.with_suffix(".so.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2]   ptxas: {line.strip()}")


def block_solve_bound(P, itemsize):
    """(bound_ms, bound_by) of one landmark block solve: the larger of the
    bytes it must move over the HBM rate (6 rows of Hpp and 3 of t read, 3
    of u written, each once) and its operations over the float32 rate."""
    by_bytes = 12 * P * itemsize / HBM_BYTES_PER_S * 1e3
    by_ops = BLOCK_SOLVE_FLOPS * P / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def phase_kernel(dev):
    """Kernel == plain version on the card; returns the kernel's record at
    P = 156000 in float32: max_abs_err, the device times ms, plain_ms and
    library_ms, and the bound."""
    errs = {}
    for dtype in (torch.float64, torch.float32):
        for P, lam, seed in ((P_FULL, 1e-3, 0), (77, 0.0, 1)):
            H, t, lam_t = _blocks(P, lam, dtype, dev, seed)
            u = landmark_block_solve(H, t, lam_t)
            u_ref = landmark_block_solve_ref(H, t, lam_t)
            torch.cuda.synchronize()
            torch.testing.assert_close(u, u_ref, rtol=RTOL[dtype], atol=0.0)
            err = (u - u_ref).abs().max().item()
            errs[(dtype, P)] = err
            print(f"[3] {str(dtype)[6:]:7s} P={P:6d}: max |kernel - plain| "
                  f"= {err:.3e} (rtol {RTOL[dtype]:g})")
    H, t, lam_t = _blocks(P_FULL, 1e-3, torch.float32, dev, 0)
    # the one library call that computes the same function: a batched LU
    # solve of the damped blocks as [P, 3, 3]; timed here, used nowhere
    A = (H.T.reshape(P_FULL, 3, 3)
         + lam_t * torch.eye(3, device=dev)).contiguous()
    b = t.T.contiguous()[..., None]
    u_lib = torch.linalg.solve(A, b)[..., 0].T
    torch.testing.assert_close(u_lib, landmark_block_solve(H, t, lam_t),
                               rtol=1e-3, atol=1e-5)
    fns = {"kernel": lambda: landmark_block_solve(H, t, lam_t),
           "plain": lambda: landmark_block_solve_ref(H, t, lam_t),
           "library": lambda: torch.linalg.solve(A, b)}
    readings = {k: [] for k in fns}
    for name in ("plain", "library", "kernel", "kernel", "library", "plain"):
        readings[name].append(_time_ms(fns[name]))
    print(f"[3] float32 P={P_FULL}, launch path (CUDA events around 200 "
          f"calls, host-bound, ms per call): {readings}")
    device = {k: device_ms_per_call(fns[k], 200)
              for k in ("plain", "library", "kernel")}
    (ms, n_k), (plain_ms, n_p), (library_ms, n_l) = (
        device[k] for k in ("kernel", "plain", "library"))
    # one kernel per call; a profiler pass can lose a few of the 200 events,
    # so the kernel's time is taken per recorded event
    if not (0.9 <= n_k <= 1.0 and ms > 0):
        raise RuntimeError(f"the profiler saw {n_k} device events and "
                           f"{ms} ms per call of the kernel; expected one "
                           f"event of positive time")
    ms = ms / n_k
    bound_ms, bound_by = block_solve_bound(P_FULL, 4)
    print(f"[3] float32 P={P_FULL}, device time per call (torch.profiler, "
          f"200 calls): kernel {ms * 1e3:.2f} us in {n_k:g} kernel, plain "
          f"torch {plain_ms * 1e3:.2f} us in {n_p:g}, torch.linalg.solve on "
          f"[P, 3, 3] {library_ms * 1e3:.2f} us in {n_l:g}; kernel at "
          f"{100 * bound_ms / ms:.0f}% of its bound")
    print(f"[3] bound: {12 * P_FULL * 4 / 1e6:.2f} MB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s = {bound_ms * 1e3:.2f} us "
          f"(by {bound_by}; {BLOCK_SOLVE_FLOPS} flop per block at "
          f"{FP32_FLOP_PER_S / 1e12:.0f} TFLOP/s = "
          f"{BLOCK_SOLVE_FLOPS * P_FULL / FP32_FLOP_PER_S * 1e6:.2f} us)")
    return {"max_abs_err": errs[(torch.float32, P_FULL)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_parity(dev):
    """The same float64 step and LM run on the card and on the CPU."""
    prob = synthetic.make_skewed_problem(
        num_cameras=29, num_points=300, mean_track=4.0, max_track=24, seed=5,
        cam_zipf=1.2)
    out = {}
    for d in (dev, torch.device("cpu")):
        state, obs = ba.state_from_bal(prob, device=d, dtype=torch.float64)
        pl = ba_pack.make_pack_layout(obs, prob.num_cameras, prob.num_points)
        step = ba_pack.solve_ba_step_pk(state, obs, pl, 1e-4, cg_maxiter=2)
        err0 = ba_pack.ba_error_pk(state, obs, pl)
        st, lam, err = ba_pack.ba_lm_run_pk(state, obs, pl, 1e-3, err0,
                                            n_iters=5, cg_maxiter=8)
        out[d.type] = [x.cpu() for x in (*step, *st, lam, err)]
    for name, a, b in zip(("xc", "xp", "poses", "cals", "points", "lam",
                           "err"), out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=0.0, msg=name)
    print(f"[4] 29-camera float64 step and 5 LM iterations: card == CPU to "
          f"rtol 1e-9 (err {float(out['cuda'][-1]):.10g}, lam "
          f"{float(out['cuda'][-2]):g})")


def phase_main(dev):
    """Full-size LM under the bench gates; returns launches in the timed
    run."""
    t0 = time.perf_counter()
    prob = synthetic.make_skewed_problem(
        num_cameras=1723, num_points=156000, mean_track=4.0, max_track=40,
        seed=2, cam_zipf=1.2)
    state, obs = ba.state_from_bal(prob, device=dev, dtype=torch.float32)
    pl = ba_pack.make_pack_layout(obs, prob.num_cameras, prob.num_points)
    err0 = ba_pack.ba_error_pk(state, obs, pl)
    err_init = float(err0)
    print(f"[5] problem C={pl.C} P={pl.P} M={pl.M} built and moved in "
          f"{time.perf_counter() - t0:.1f} s; initial error {err_init:.6g}")
    iters, cg = 10, 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ba_pack.ba_lm_run_pk(state, obs, pl, 1e-3, err0, n_iters=iters,
                         cg_maxiter=cg)
    torch.cuda.synchronize()
    print(f"[5] warm-up run of {iters} iterations: "
          f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    landmark_block_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, lam, err = ba_pack.ba_lm_run_pk(state, obs, pl, 1e-3, err0,
                                       n_iters=iters, cg_maxiter=cg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = landmark_block_solve.launches
    err_final = float(err)
    rms = float(np.sqrt(2.0 * err_final / pl.M))
    print(f"[5] error {err_init:.6g} -> {err_final:.6g}, rms {rms:.4f} px, "
          f"lambda {float(lam):g}")
    print(f"[5] {iters} timed LM iterations (cg={cg}) in {dt:.4f} s: "
          f"{iters / dt:.3f} it/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
          f"landmark_block_solve.launches = {launches}")
    if not np.isfinite(err_final):
        raise RuntimeError(f"gate: non-finite BA error {err_final}")
    if not err_final < err_init:
        raise RuntimeError(f"gate: BA error did not decrease: {err_init} -> "
                           f"{err_final}")
    if not rms < 1.3:
        raise RuntimeError(f"gate: rms reprojection {rms:.4f} px >= 1.3 px")
    if launches <= 0:
        raise RuntimeError("the main path launched no landmark_block_solve "
                           "kernel")
    return launches


def _pose_graph_run(graph, initial, plan, lam0, n_iters):
    """(values, lam, err, err0) of `n_iters` LM iterations with the
    partitioned-Schur solver."""
    err0 = optimizers.graph_error(graph, initial)
    v, lam, err = optimizers.lm_run(
        graph, initial, lam0, err0, n_iters,
        optimizers.Params(solver="schur"), plan)
    return v, lam, err, err0


def phase_pose_parity(dev):
    """The float64 pose-graph path on the card against the CPU, and the
    partitioned solve against the dense solve on the card."""
    n, part = 300, 32
    # From lambda0 = 1e2 each of the 6 iterations lowers the error by far
    # more than rounding, so card and CPU take the same accept/reject
    # decisions; from 1e-5 this graph converges to the last bit within 5,
    # and a later decision compares errors that differ by rounding alone.
    lam0, iters = 1e2, 6
    out = {}
    for d in (dev, torch.device("cpu")):
        graph, initial, _ = manhattan.make_manhattan(
            n, seed=3, device=d, dtype=torch.float64)
        plan = schur.make_plan(graph, {"se2": n}, max_part_size=part)
        lin = linearize(graph, initial)
        step = schur.solve_partitioned(lin, plan, 1e-3)["se2"]
        if d.type == "cuda":
            dense = solvers.solve_dense(lin, Layout.of(initial), 1e-3)["se2"]
            torch.testing.assert_close(step, dense, rtol=0.0, atol=1e-8)
            gap = (step - dense).abs().max().item()
        v, lam, err, _ = _pose_graph_run(graph, initial, plan, lam0, iters)
        out[d.type] = [x.cpu() for x in (step, v["se2"], lam, err)]
    for name, a, b in zip(("step", "poses", "lam", "err"), out["cuda"],
                          out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, msg=name)
    print(f"[6] {n}-pose float64 graph, {plan.stats()}: partitioned solve "
          f"and {iters} LM iterations, card == CPU to rtol 1e-9 (err "
          f"{float(out['cuda'][3]):.10g}, lam {float(out['cuda'][2]):g}); "
          f"on the card max |partitioned - dense| = {gap:.2e} (atol 1e-8)")


def _se3_chain(n, device, dtype):
    """A seeded SE(3) graph: prior, noisy odometry and loop closures every
    fifth pose, started from perturbed poses."""
    rng = np.random.default_rng(11)

    def t64(a):
        return torch.tensor(a, dtype=torch.float64)
    truth = se3.expmap(t64(np.concatenate(
        [0.4 * rng.normal(size=(n, 3)), 3.0 * rng.normal(size=(n, 3))], 1)))
    gb = GraphBuilder()
    F.add_prior(gb, "se3", 0, truth[0].numpy(),
                F.diag_noise([0.01] * 3 + [0.05] * 3))
    for i, j in [(i, i + 1) for i in range(n - 1)] + [
            (i, i + 7) for i in range(0, n - 7, 5)]:
        rel = se3.retract(se3.between(truth[i], truth[j]),
                          t64(0.01 * rng.normal(size=6)))
        F.add_between(gb, "se3", i, j, rel.numpy(),
                      F.diag_noise([0.02] * 3 + [0.1] * 3))
    init = se3.retract(truth, t64(0.05 * rng.normal(size=(n, 6))))
    return (gb.build(device=device, dtype=dtype),
            values_from_numpy({"se3": init.numpy()}, device=device,
                              dtype=dtype))


def phase_se3_parity(dev):
    """SE(3) through the manifold registry on the card: 5 dense LM
    iterations in float64 against the CPU, and float32 Jacobians that stay
    float32 through SE(3)'s matrix products."""
    n, iters = 40, 5
    params = optimizers.Params(solver="dense")
    out = {}
    for d in (dev, torch.device("cpu")):
        graph, initial = _se3_chain(n, d, torch.float64)
        err0 = optimizers.graph_error(graph, initial)
        v, lam, err = optimizers.lm_run(graph, initial, 1e-3, err0, iters,
                                        params)
        out[d.type] = [x.cpu() for x in (v["se3"], lam, err, err0)]
    for name, a, b in zip(("poses", "lam", "err", "err0"), out["cuda"],
                          out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, msg=name)
    graph, initial = _se3_chain(n, dev, torch.float32)
    lin = linearize(graph, initial)
    if any(J.dtype != torch.float32 for b in lin.batches for J in b.Js):
        raise RuntimeError("float32 SE(3) Jacobians are not float32")
    err0 = optimizers.graph_error(graph, initial)
    _, _, err32 = optimizers.lm_run(graph, initial, 1e-3, err0, iters, params)
    e64 = float(out["cuda"][2])
    if not abs(float(err32) - e64) <= 1e-2 * e64:
        raise RuntimeError(f"float32 SE(3) error {float(err32)} is not "
                           f"within 1e-2 relative of float64 {e64}")
    print(f"[6] {n}-pose SE(3) graph, {graph.num_factors} factors, {iters} "
          f"dense LM iterations: float64 card == CPU to rtol 1e-9 (err "
          f"{float(out['cuda'][3]):.6g} -> {e64:.10g}); float32 on the card "
          f"ends at {float(err32):.6g}")


def phase_pose_main(dev):
    """Batch LM on the 10000-pose graph under its gates; returns the final
    float64 error, the batch optimum that phase 10 is held to."""
    n, part, lam0, iters = POSE_N, POSE_PART, POSE_LAM0, POSE_ITERS
    runs = {}
    for dtype in (torch.float32, torch.float64):
        t0 = time.perf_counter()
        graph, initial, truth = manhattan.make_manhattan(
            n, seed=42, device=dev, dtype=dtype)
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = schur.make_plan(graph, {"se2": n}, max_part_size=part)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        name = str(dtype)[6:]
        if dtype == torch.float32:
            print(f"[7] {n} poses, {graph.num_factors} factors, made in "
                  f"{t_gen:.1f} s; plan {plan.stats()} built on the host in "
                  f"{t_plan:.2f} s (native symbolic library: "
                  f"{native.get_lib() is not None})")
        torch.cuda.reset_peak_memory_stats()
        landmark_block_solve.launches = 0
        dts = []
        for _ in range(4):          # a warm-up run, then three timed runs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            v, lam, err, err0 = _pose_graph_run(graph, initial, plan, lam0,
                                                iters)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        launches = landmark_block_solve.launches
        ate0, ate = (metrics.ate(x["se2"][:, :2].cpu().numpy(),
                                 truth[:, :2])["rmse"] for x in (initial, v))
        runs[name] = (float(err0), float(err), ate)
        print(f"[7] {name}: error {float(err0):.6g} -> {float(err):.6g}, "
              f"lambda {float(lam):g}, ATE rmse {ate0:.2f} m -> {ate:.4f} m")
        print(f"[7] {name}: warm-up run of {iters} LM iterations "
              f"{dts[0]:.3f} s, then three timed runs "
              + ", ".join(f"{dt:.4f}" for dt in dts[1:]) + " s: "
              + ", ".join(f"{iters / dt:.3f}" for dt in dts[1:])
              + f" it/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
              f"landmark_block_solve.launches = {launches} (this path holds "
              f"no hand-written kernel: its JAX counterpart has no Pallas "
              f"kernel)")
        del graph, initial, plan, v
    e0, e32, ate32 = runs["float32"]
    _, e64, ate64 = runs["float64"]
    if not np.isfinite(e32):
        raise RuntimeError(f"gate: non-finite pose-graph error {e32}")
    if not e32 < e0:
        raise RuntimeError(f"gate: pose-graph error did not decrease: {e0} "
                           f"-> {e32}")
    if not abs(e32 - e64) <= 1e-3 * abs(e64):
        raise RuntimeError(f"gate: float32 error {e32} is not within 1e-3 "
                           f"relative of the float64 error {e64}")
    if not ate32 < 0.5:
        raise RuntimeError(f"gate: ATE rmse {ate32:.4f} m >= 0.5 m")
    print(f"[7] gates passed: float32 vs float64 error rel "
          f"{abs(e32 - e64) / abs(e64):.2e} (< 1e-3), ATE rmse "
          f"{ate32:.4f} m (< 0.5; float64 {ate64:.4f} m)")
    return e64


def _harvest(graph, values, group):
    """(D, O) [n, d, d] of the chain preconditioner of `group`, as the
    ISAM2 engine harvests them from a linearized graph."""
    lin = linearize(graph, values)
    return (lin.hessian_block_diagonal()[group],
            isam2._chain_offdiag(lin, group))


def _spd_chain(d, cap, dev, seed):
    """A seeded block-tridiagonal SPD system (D, O) [cap, d, d] in
    float64."""
    rng = np.random.default_rng(seed)
    A, B = rng.normal(size=(2, cap, d, d))
    D = 0.5 * np.eye(d) + np.einsum("kij,kil->kjl", A, A)
    D[1:] += np.einsum("kij,kil->kjl", B[:-1], B[:-1])
    O = np.einsum("kij,kil->kjl", A, B)
    return torch.tensor(D, device=dev), torch.tensor(O, device=dev)


def _pad(a, cap):
    return torch.cat([a, a.new_zeros((cap - a.shape[0],) + a.shape[1:])])


def chain_bound(cap, d, itemsize):
    """(bound_ms, bound_by) of one chain factorization: the larger of its
    bytes (D and O read, Uinv written, each once) over the HBM rate and its
    operations (per block two d^3 products and a d^3 inverse, 2 flop each)
    over the float32 rate. Neither is what limits the kernel: see the
    dependent-chain figure that phase 8 prints."""
    by_bytes = 3 * cap * d * d * itemsize / HBM_BYTES_PER_S * 1e3
    by_ops = 6 * d ** 3 * cap / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else \
        "operations"


def phase_chain(dev):
    """The chain numerics on the card; returns the chain_factorize kernel's
    record at capacity 16384, d = 3, float32."""
    def check(name, D, O, nvar, dtype):
        Dm, Om = chain.chain_prepare(D.to(dtype), O.to(dtype), nvar,
                                     CHAIN_LAM)
        U = chain_factorize(Dm, Om)
        U_ref = chain.chain_factorize_ref(Dm, Om)
        torch.cuda.synchronize()
        scale = U_ref.abs().max().item()
        err = (U - U_ref).abs().max().item()
        print(f"[8] {name} {str(dtype)[6:]}: max |kernel - plain| = "
              f"{err:.3e}, largest entry {scale:.3e} (rtol "
              f"{CHAIN_RTOL[dtype]:g} of it)")
        if not err <= CHAIN_RTOL[dtype] * scale:
            raise RuntimeError(f"chain_factorize kernel disagrees with its "
                               f"plain version: {name} {dtype} {err}")
        return err

    g2, v2, _ = manhattan.make_manhattan(256, seed=7, device=dev,
                                         dtype=torch.float64)
    D3, O3 = _harvest(g2, v2, "se2")
    D6, O6 = _harvest(*_se3_chain(256, dev, torch.float64), "se3")
    gN, vN, _ = manhattan.make_manhattan(POSE_N, seed=42, device=dev,
                                         dtype=torch.float64)
    linN = linearize(gN, vN)
    DN = _pad(linN.hessian_block_diagonal()["se2"], CHAIN_CAP)
    ON = _pad(isam2._chain_offdiag(linN, "se2"), CHAIN_CAP)
    rN = _pad(linN.gradient_at_zero()["se2"], CHAIN_CAP)
    for dtype in (torch.float64, torch.float32):
        check("d=3, 256 Manhattan poses, cap 256", D3, O3, 256, dtype)
        check("d=6, 256 SE(3) poses, cap 256", D6, O6, 256, dtype)
        check("d=4, seeded SPD chain, cap 64, 37 active",
              *_spd_chain(4, 64, dev, 4), 37, dtype)
        check("d=15, seeded SPD chain, cap 64, 37 active",
              *_spd_chain(15, 64, dev, 15), 37, dtype)
    check(f"d=3, {POSE_N} Manhattan poses, cap {CHAIN_CAP}", DN, ON, POSE_N,
          torch.float64)
    err32 = check(f"d=3, {POSE_N} Manhattan poses, cap {CHAIN_CAP}", DN, ON,
                  POSE_N, torch.float32)

    # float32 against float64 at full length, factorize + apply
    x = {}
    for dtype in (torch.float32, torch.float64):
        Dm, Om = chain.chain_prepare(DN.to(dtype), ON.to(dtype), POSE_N,
                                     CHAIN_LAM)
        U = chain_factorize(Dm, Om)
        x[dtype] = chain.chain_apply(U, *chain.chain_scan_templates(U, Om),
                                     rN.to(dtype)).double()
    rel = ((x[torch.float32] - x[torch.float64]).norm()
           / x[torch.float64].norm()).item()
    print(f"[8] cap {CHAIN_CAP}, {POSE_N} active blocks: factorize + "
          f"chain_apply in float32 against float64, relative error of the "
          f"applied gradient {rel:.3e} (< 1e-3)")
    if not rel < 1e-3:
        raise RuntimeError(f"gate: float32 chain is {rel} from float64")

    # times at capacity 16384
    rec = {}
    for d, D, O, nvar in ((3, DN, ON, POSE_N),
                          (6, D6.repeat(64, 1, 1), O6.repeat(64, 1, 1),
                           CHAIN_CAP)):
        Dm, Om = chain.chain_prepare(D.float(), O.float(), nvar, CHAIN_LAM)
        # a kernel of milliseconds: CUDA events around 20 launches time it
        # well; the profiler's figure per kernel event stands beside it (a
        # profiler pass can lose events, so it is not divided by the calls)
        ms = _time_ms(lambda: chain_factorize(Dm, Om), 20)
        p_ms, p_n = device_ms_per_call(lambda: chain_factorize(Dm, Om), 20)
        if not (ms > 0 and p_n > 0):
            raise RuntimeError(f"chain_factorize d={d}: {ms} ms per call by "
                               f"events, {p_n} profiler events per call")
        bound_ms, bound_by = chain_bound(CHAIN_CAP, d, 4)
        print(f"[8] chain_factorize float32 cap {CHAIN_CAP} d={d}: "
              f"{ms:.4f} ms per call (CUDA events, 20 calls; torch.profiler "
              f"{p_ms / p_n:.4f} ms per kernel event, {20 * p_n:g} of 20 "
              f"recorded), {ms / CHAIN_CAP * 1e6:.1f} ns per block: the "
              f"dependent chain is what limits it; bound "
              f"{bound_ms * 1e3:.3f} us by {bound_by} (3 x {CHAIN_CAP} x "
              f"{d * d} x 4 B at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
        if d == 3:
            U = chain_factorize(Dm, Om)
            Tf, Tb = chain.chain_scan_templates(U, Om)
            r = rN.float()
            a_ms, a_n = device_ms_per_call(
                lambda: chain.chain_apply(U, Tf, Tb, r), 20)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chain.chain_factorize_ref(Dm, Om)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            Ds, Os = chain.chain_prepare(D3.float(), O3.float(), 256,
                                         CHAIN_LAM)
            chain.chain_factorize_ref(Ds, Os)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            chain.chain_factorize_ref(Ds, Os)
            torch.cuda.synchronize()
            plain256 = (time.perf_counter() - t0) * 1e3
            print(f"[8] chain_apply float32 cap {CHAIN_CAP} d=3: device "
                  f"time {a_ms:.4f} ms per call in {a_n:g} device events; "
                  f"plain chain_factorize (a Python loop, host clock, one "
                  f"call): {plain_ms:.1f} ms at cap {CHAIN_CAP}, "
                  f"{plain256:.2f} ms at cap 256")
            rec = {"max_abs_err": err32, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
    return rec


def _isam_small(dev, data):
    """The small float64 stream of phase 9 through an engine on `dev`:
    update records, then 20 poses marginalized and two more updates."""
    isam = profile_isam2.make_engine(data, device=dev, dtype=torch.float64,
                                     cg_maxiter=300, cg_tol=1e-10)
    recs = profile_isam2.run_stream(isam, data)
    out = [([r[2] for r in recs], [r[3] for r in recs],
            isam.estimate_array("se2"), isam.error())]
    isam.marginalize_variables({"se2": list(range(20))})
    res = [isam.update() for _ in range(2)]
    out.append(([r.relinearized_rows for r in res],
                [r.cg_iterations for r in res],
                isam.estimate_array("se2")[20:], isam.error()))
    return out


def phase_isam_parity(dev):
    """The float64 ISAM2 stream on the card against the CPU."""
    n = 200
    graph, _, _ = manhattan.make_manhattan(n, seed=5, device="cpu",
                                           dtype=torch.float64)
    data = profile_isam2.stream_data(graph)
    launches0 = chain_factorize.launches
    card = _isam_small(dev, data)
    launches = chain_factorize.launches - launches0
    cpu = _isam_small(torch.device("cpu"), data)
    for what, a, b in zip(("stream", "after eviction"), card, cpu):
        if a[0] != b[0]:
            raise RuntimeError(f"[9] {what}: relinearized rows differ: "
                               f"{a[0]} on the card, {b[0]} on the CPU")
        # CG's residual norm is not monotone and the card sums in another
        # order: after tens of iterations the stop test can fire an
        # iteration or two apart
        gap = max(abs(x - y) for x, y in zip(a[1], b[1]))
        if gap > 2:
            raise RuntimeError(f"[9] {what}: CG iterations differ by {gap}: "
                               f"{a[1]} on the card, {b[1]} on the CPU")
        np.testing.assert_allclose(a[2], b[2], rtol=0, atol=1e-8)
        np.testing.assert_allclose(a[3], b[3], rtol=1e-9)
        print(f"[9] {what}: {len(a[0])} updates, card == CPU: relinearized "
              f"rows equal (max {max(a[0])}), CG iterations within {gap} "
              f"(max {max(a[1])}), estimates max |diff| "
              f"{np.abs(a[2] - b[2]).max():.2e} (atol 1e-8), error "
              f"{a[3]:.10g} (rel 1e-9)")
    print(f"[9] {n}-pose float64 stream, {len(data['ij'])} measurements, "
          f"chain:se2, CG to 1e-10; 20 poses marginalized; "
          f"chain_factorize.launches on the card = {launches}")
    return data, card[0][2:]


def phase_isam_main(dev, batch_optimum):
    """The full stream in float32 under its gates; returns the
    chain_factorize launches of the stream."""
    t0 = time.perf_counter()
    graph, _, truth = manhattan.make_manhattan(ISAM_N, seed=42, device=dev,
                                               dtype=torch.float32)
    data = profile_isam2.stream_data(graph)
    n_meas = len(data["ij"])
    tail_from = int(np.argmax(data["ij"].max(axis=1) >= ISAM_SWITCH_POSE))
    print(f"[10] {ISAM_N} poses, {n_meas} measurements, made in "
          f"{time.perf_counter() - t0:.1f} s; float32, {ISAM_PARAMS}; an "
          f"update every {ISAM_UPDATE_EVERY} measurements up to pose "
          f"{ISAM_SWITCH_POSE}, then after each of the last "
          f"{n_meas - tail_from}")
    torch.cuda.reset_peak_memory_stats()
    chain_factorize.launches = 0
    landmark_block_solve.launches = 0
    t0 = time.perf_counter()
    isam = profile_isam2.make_engine(data, device=dev, dtype=torch.float32)
    recs = profile_isam2.run_stream(isam, data,
                                    update_every=ISAM_UPDATE_EVERY,
                                    switch_pose=ISAM_SWITCH_POSE)
    res = profile_isam2.polish(isam)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = chain_factorize.launches
    for lo in range(0, ISAM_N, 1000):
        seg = [r for r in recs if lo < r[0] <= lo + 1000
               and r[0] < ISAM_SWITCH_POSE]
        if seg:
            k, ms, rmed, rmax, cmed, cmax = profile_isam2.summarize(seg)
            print(f"[10]   poses {lo + 1:5d}-{seg[-1][0]:5d}: {ms:8.2f} ms "
                  f"per update ({k} updates, one per {ISAM_UPDATE_EVERY} "
                  f"measurements); relinearized rows median {rmed:g} max "
                  f"{rmax}; CG iterations median {cmed:g} max {cmax}")
    tail = [r for r in recs if r[0] >= ISAM_SWITCH_POSE]
    k, ms, rmed, rmax, cmed, cmax = profile_isam2.summarize(tail)
    print(f"[10] per-measurement tail, poses {ISAM_SWITCH_POSE}-{ISAM_N}: "
          f"{ms:.3f} ms per update over {k} updates (median "
          f"{1e3 * float(np.median([r[1] for r in tail])):.3f}, max "
          f"{1e3 * max(r[1] for r in tail):.1f}); relinearized rows median "
          f"{rmed:g} max {rmax}; CG iterations median {cmed:g} max {cmax}")
    err = isam.error()
    est = isam.estimate_array("se2")
    ate = metrics.ate(est[:, :2], truth[:, :2])["rmse"]
    print(f"[10] {len(recs)} updates and {len(res)} polishing updates in "
          f"{wall:.1f} s; final error {err:.6g} (float64 batch optimum "
          f"{batch_optimum:.6g}, ratio {err / batch_optimum:.5f}); ATE rmse "
          f"{ate:.4f} m; chain_factorize.launches = {launches}; state "
          f"capacity {isam._cap_n['se2']} poses; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; "
          f"landmark_block_solve.launches = {landmark_block_solve.launches}")
    if est.shape != (ISAM_N, 3):
        raise RuntimeError(f"gate: estimate has shape {est.shape}")
    if not np.isfinite(err):
        raise RuntimeError(f"gate: non-finite ISAM2 error {err}")
    if not err <= 1.05 * batch_optimum:
        raise RuntimeError(f"gate: ISAM2 error {err} above 1.05 x the batch "
                           f"optimum {batch_optimum}")
    if not ate < 0.5:
        raise RuntimeError(f"gate: ATE rmse {ate:.4f} m >= 0.5 m")
    if launches <= 0:
        raise RuntimeError("the stream launched no chain_factorize kernel")
    return launches

def phase_checkpoint(dev, data, ref, tmp):
    """save_isam2 / load_isam2 at update 100 of phase 9's stream on the
    card, against the uninterrupted card engine `ref` (estimates, error);
    then an lm_run restarted through save_lm_carry / load_lm_carry."""
    isam = profile_isam2.make_engine(data, device=dev, dtype=torch.float64,
                                     cg_maxiter=300, cg_tol=1e-10)
    profile_isam2.run_stream(isam, data, 0, 100)
    path = f"{tmp}/isam2_update100.npz"
    t0 = time.perf_counter()
    serialization.save_isam2(path, isam)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = serialization.load_isam2(path, device=dev)
    t_load = time.perf_counter() - t0
    profile_isam2.run_stream(resumed, data, 100, None)
    est, err = resumed.estimate_array("se2"), resumed.error()
    gap = np.abs(est - ref[0]).max()
    print(f"[9] checkpoint: saved at update 100 ({t_save:.2f} s, "
          f"{os.path.getsize(path) / 2**20:.2f} MiB), loaded "
          f"onto the card ({t_load:.2f} s), streamed on to the end: "
          f"estimates max |resumed - uninterrupted| = {gap:.2e} (atol "
          f"1e-12), error {err:.12g} against {ref[1]:.12g}")
    if not gap <= 1e-12 or not abs(err - ref[1]) <= 1e-12 * abs(ref[1]):
        raise RuntimeError(f"[9] the resumed ISAM2 stream left the "
                           f"uninterrupted one: {gap}, {err} vs {ref[1]}")

    graph, initial, _ = manhattan.make_manhattan(300, seed=3, device=dev,
                                                 dtype=torch.float64)
    plan = schur.make_plan(graph, {"se2": 300}, max_part_size=32)
    params = optimizers.Params(solver="schur")
    err0 = optimizers.graph_error(graph, initial)
    full = optimizers.lm_run(graph, initial, 1e2, err0, 6, params, plan)
    half = optimizers.lm_run(graph, initial, 1e2, err0, 3, params, plan)
    serialization.save_lm_carry(f"{tmp}/lm_carry.npz", *half)
    carry = serialization.load_lm_carry(f"{tmp}/lm_carry.npz", device=dev,
                                        dtype=torch.float64)
    rest = optimizers.lm_run(graph, *carry, 3, params, plan)
    vgap = (rest[0]["se2"] - full[0]["se2"]).abs().max().item()
    egap = abs(float(rest[2]) - float(full[2])) / float(full[2])
    print(f"[9] lm_run 6 iterations == 3 + save_lm_carry/load_lm_carry + 3 "
          f"on the card: lambda {float(rest[1]):g} and {float(full[1]):g}, "
          f"error rel gap {egap:.2e}, values max gap {vgap:.2e}, bitwise "
          f"equal: {bool(torch.equal(rest[0]['se2'], full[0]['se2']))}")
    if (float(rest[1]) != float(full[1]) or not egap <= 1e-12
            or not vgap <= 1e-12):
        raise RuntimeError("[9] the restarted lm_run left the "
                           "uninterrupted one")


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, dev):
    """(fn(), seconds between synchronizes)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _peak_mib(dev):
    return (torch.cuda.max_memory_allocated() / 2**20
            if torch.device(dev).type == "cuda" else float("nan"))


def _lm_from_file(graph, initial, dev, label, max_part=128):
    """make_plan + optimize_lm(schur, 30 iterations) as the tool runs them;
    returns (result, plan seconds, LM seconds, initial error)."""
    err0 = float(optimizers.graph_error(graph, initial))
    plan, t_plan = _timed(lambda: schur.make_plan(
        graph, initial.counts(), max_part_size=max_part), dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    res, t_lm = _timed(lambda: optimizers.optimize_lm(
        graph, initial, optimizers.Params(solver="schur", max_iterations=30),
        plan=plan), dev)
    print(f"[{label}] plan {plan.stats()} in {t_plan:.2f} s; LM error "
          f"{err0:.6g} -> {res.error:.9g} in {res.iterations} iterations, "
          f"{t_lm:.3f} s ({res.iterations / t_lm:.3f} it/s), converged "
          f"{res.converged}, lambda {res.lambda_final:g}; peak memory "
          f"{_peak_mib(dev):.0f} MiB")
    return res, t_plan, t_lm, err0


def phase_file_2d(dev, batch_optimum, tmp):
    """The 2D file path at city10000 scale under its gates."""
    graph, initial, truth = manhattan.make_manhattan(
        POSE_N, seed=42, device=dev, dtype=torch.float64)
    path = f"{tmp}/manhattan{POSE_N}.g2o"
    _, t_write = _timed(lambda: dataset.write_g2o_2d(path, initial, graph),
                        dev)
    e_orig = float(graph.error(initial))
    # the writer's diagonal information matrices have the zero pattern that
    # noise_format="auto" takes for a covariance (the reference's rule,
    # dataset.cpp:219): read as "g2o", the format the writer writes, and
    # print what "auto" makes of the file
    g_auto, _ = dataset.load_2d(path, noise_format="auto", device=dev,
                                dtype=torch.float64)
    e_auto = float(g_auto.error(initial))
    del g_auto
    results = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        (g, v), t_parse = _timed(lambda: dataset.load_2d(
            path, noise_format="g2o", device=dev, dtype=dtype), dev)
        if dtype == torch.float64:
            e_read = float(g.error(initial))
            print(f"[11] {POSE_N} poses, {graph.num_factors} factors: "
                  f"written in {t_write:.2f} s; read back as g2o in "
                  f"{t_parse:.2f} s: error at the written values "
                  f"{e_read:.12g}, original graph {e_orig:.12g}; read back "
                  f"with noise_format='auto' (taken for a covariance): "
                  f"{e_auto:.12g}")
            if not abs(e_read - e_orig) <= 1e-9 * abs(e_orig):
                raise RuntimeError(f"[11] the graph read back has error "
                                   f"{e_read}, the original {e_orig}")
        n = v["se2"].shape[0]
        init, t_lago = _timed(lambda: initialize.lago_init_2d(g, n), dev)
        e_lago = float(optimizers.graph_error(g, init))
        print(f"[11] {name}: parse {t_parse:.2f} s; lago_init_2d (PCG "
              f"branch) {t_lago:.2f} s: error {float(g.error(v)):.6g} -> "
              f"{e_lago:.6g}")
        res, t_plan, t_lm, _ = _lm_from_file(g, init, dev, 11)
        ate = metrics.ate(res.values["se2"][:, :2].cpu().numpy(),
                          truth[:, :2])["rmse"]
        results[name] = (e_lago, res.error, ate)
        print(f"[11] {name}: seconds per step: parse {t_parse:.2f}, LAGO "
              f"{t_lago:.2f}, plan {t_plan:.2f}, LM {t_lm:.2f}; "
              f"{res.iterations} LM iterations; ATE rmse {ate:.4f} m")
    e0, e64, ate64 = results["float64"]
    _, e32, ate32 = results["float32"]
    if not (np.isfinite(e32) and e32 < e0 and e64 < e0):
        raise RuntimeError(f"gate: [11] error did not decrease: {e0} -> "
                           f"{e64} (float64), {e32} (float32)")
    if not abs(e32 - e64) <= 1e-3 * e64:
        raise RuntimeError(f"gate: [11] float32 {e32} not within 1e-3 of "
                           f"float64 {e64}")
    if not abs(e64 - batch_optimum) <= 0.01 * batch_optimum:
        raise RuntimeError(f"gate: [11] float64 {e64} not within 1% of the "
                           f"batch optimum {batch_optimum}")
    if not max(ate32, ate64) < 0.5:
        raise RuntimeError(f"gate: [11] ATE rmse {ate32}, {ate64} >= 0.5 m")
    print(f"[11] gates passed: float32 vs float64 rel "
          f"{abs(e32 - e64) / e64:.2e} (< 1e-3); float64 {e64:.9g} vs phase "
          f"7's {batch_optimum:.9g}, rel {abs(e64 - batch_optimum) / batch_optimum:.2e} "
          f"(< 1e-2); ATE rmse {ate32:.4f} / {ate64:.4f} m (< 0.5)")


def sphere_standin(seed=0):
    """(truth [N, 3, 4], edges [(i, j)], measurements [K, 3, 4], vertices
    [N, 3, 4]) of the stand-in of sphere2500.txt, in numpy float64."""
    rng = np.random.default_rng(seed)
    lat = -np.pi / 2 + np.pi * (np.arange(SPHERE_RINGS) + 1) / (
        SPHERE_RINGS + 1)
    lon = 2 * np.pi * np.arange(SPHERE_PER_RING) / SPHERE_PER_RING
    la, lo = [a.ravel() for a in np.meshgrid(lat, lon, indexing="ij")]
    z = np.stack([np.cos(la) * np.cos(lo), np.cos(la) * np.sin(lo),
                  np.sin(la)], 1)                   # outward normal
    x = np.stack([-np.sin(lo), np.cos(lo), np.zeros_like(lo)], 1)  # heading
    R = np.stack([x, np.cross(z, x), z], 2)
    truth = np.concatenate([R, SPHERE_RADIUS * z[:, :, None]], 2)
    n = len(truth)
    edges = [(k, k + 1) for k in range(n - 1)] + [
        (k, k - SPHERE_PER_RING) for k in range(SPHERE_PER_RING, n)]
    T = torch.tensor(truth)
    ij = torch.tensor(edges)
    xi = rng.normal(size=(len(edges), 6)) * np.asarray(SPHERE_SIGMAS)
    meas = se3.compose(se3.between(T[ij[:, 0]], T[ij[:, 1]]),
                       se3.expmap(torch.tensor(xi))).numpy()
    verts = [truth[0]]
    for k in range(n - 1):
        verts.append(se3.compose(torch.tensor(verts[-1]),
                                 torch.tensor(meas[k])).numpy())
    return truth, edges, meas, np.stack(verts)


def write_sphere(path):
    """Write the stand-in as VERTEX_SE3:QUAT / EDGE_SE3:QUAT text; returns
    the truth."""
    truth, edges, meas, verts = sphere_standin()
    gb = GraphBuilder()
    noise = F.diag_noise(SPHERE_SIGMAS)
    for (i, j), m in zip(edges, meas):
        F.add_between(gb, "se3", i, j, m, noise)
    dataset.write_g2o_3d(path, values_from_numpy(
        {"se3": verts}, device="cpu", dtype=torch.float64),
        gb.build(device="cpu", dtype=torch.float64), fmt="quat")
    return truth


def _ate3(values, truth):
    return metrics.ate(values["se3"][:, :, 3].cpu().numpy(),
                       truth[:, :, 3])["rmse"]


def phase_file_3d(dev, tmp):
    """The 3D file path on the sphere2500-shaped stand-in under its
    gates."""
    path = f"{tmp}/sphere_standin.g2o"
    truth, t_write = _timed(lambda: write_sphere(path), dev)
    results = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        (g, v), t_parse = _timed(lambda: dataset.load_3d(
            path, device=dev, dtype=dtype), dev)
        n = v["se3"].shape[0]
        e_odo = float(optimizers.graph_error(g, v))
        init, t_init = _timed(lambda: initialize.chordal_init_f64(
            g, n, device=dev, dtype=dtype), dev)
        e_chordal = float(optimizers.graph_error(g, init))
        print(f"[12] {name}: {n} poses, {g.num_factors - 1} edges; written "
              f"in {t_write:.2f} s, parsed in {t_parse:.2f} s; odometry "
              f"error {e_odo:.6g}; chordal_init_f64 (host) {t_init:.2f} s: "
              f"error {e_chordal:.6g}")
        res, t_plan, t_lm, _ = _lm_from_file(g, init, dev, 12)
        ate = _ate3(res.values, truth)
        results[name] = (e_odo, e_chordal, res.error, ate)
        print(f"[12] {name}: seconds per step: parse {t_parse:.2f}, chordal "
              f"{t_init:.2f}, plan {t_plan:.2f}, LM {t_lm:.2f}; "
              f"{res.iterations} LM iterations; SE(3)-aligned ATE rmse "
              f"{ate:.4f} m (odometry {_ate3(v, truth):.4f}, chordal "
              f"{_ate3(init, truth):.4f})")
        dv, t_dev = _timed(lambda: initialize.chordal_init(g, n), dev)
        print(f"[12] {name}: device chordal_init (PCG branch, {t_dev:.2f} "
              f"s) reaches error {float(optimizers.graph_error(g, dv)):.6g}"
              f" (host float64 chordal {e_chordal:.6g}); a record, not a "
              f"gate")
        if dtype == torch.float64:
            out = f"{tmp}/sphere_result.g2o"
            dataset.write_g2o_3d(out, res.values, g, fmt="quat")
            g2, v2 = dataset.load_3d(out, device=dev, dtype=dtype)
            e_re = float(optimizers.graph_error(g2, v2))
            print(f"[12] result written and read back: odometry error of "
                  f"the reload {e_re:.12g}, final {res.error:.12g}")
            if not abs(e_re - res.error) <= 1e-9 * res.error:
                raise RuntimeError(f"[12] round trip: {e_re} vs "
                                   f"{res.error}")
    e_odo, e_ch, e64, ate64 = results["float64"]
    _, _, e32, ate32 = results["float32"]
    if not e_ch < e_odo:
        raise RuntimeError(f"gate: [12] chordal error {e_ch} not below the "
                           f"odometry error {e_odo}")
    if not (np.isfinite(e32) and e64 < e_ch and e32 < e_ch):
        raise RuntimeError(f"gate: [12] LM error did not decrease: {e_ch} "
                           f"-> {e64}, {e32}")
    if not abs(e32 - e64) <= 1e-3 * e64:
        raise RuntimeError(f"gate: [12] float32 {e32} not within 1e-3 of "
                           f"float64 {e64}")
    if not abs(e64 - SPHERE_OPTIMUM) <= 0.2 * SPHERE_OPTIMUM:
        raise RuntimeError(f"gate: [12] float64 {e64} not within 20% of "
                           f"{SPHERE_OPTIMUM}")
    if not max(ate32, ate64) < SPHERE_ATE_BOUND:
        raise RuntimeError(f"gate: [12] ATE rmse {ate32}, {ate64} >= "
                           f"{SPHERE_ATE_BOUND} m")
    print(f"[12] gates passed: chordal {e_ch:.6g} < odometry {e_odo:.6g}; "
          f"float32 vs float64 rel {abs(e32 - e64) / e64:.2e} (< 1e-3); "
          f"float64 {e64:.6g} vs expectation {SPHERE_OPTIMUM:g} (within "
          f"20%); ATE rmse {ate32:.4f} / {ate64:.4f} m (< "
          f"{SPHERE_ATE_BOUND})")


def phase_breadth(dev):
    """Every name residual_by_name knows: 4096 seeded factors linearized on
    the card and on the CPU in float64."""
    names = F.residual_names()
    worst = (0.0, None)
    t0 = time.perf_counter()
    for name in names:
        s = factor_samples.sample(name, BREADTH_K, seed=13)
        out = []
        for d in (dev, torch.device("cpu")):
            blocks, idx = {}, []
            for grp, p in zip(s["groups"], s["points"]):
                off = blocks[grp].shape[0] if grp in blocks else 0
                blocks[grp] = (np.concatenate([blocks[grp], p])
                               if grp in blocks else p)
                idx.append(np.arange(BREADTH_K) + off)
            batch = FactorBatch(
                name, F.residual_by_name(name), s["groups"], s["rdim"],
                torch.tensor(np.stack(idx, 1), device=d),
                {k: torch.tensor(v, device=d) for k, v in s["meas"].items()},
                NoiseModel("unit"))
            lb = linearize_batch(batch, Values({
                grp: torch.tensor(p, device=d) for grp, p in blocks.items()}))
            out.append([lb.r.cpu()] + [J.cpu() for J in lb.Js])
        for what, a, b in zip(["r"] + [f"J{k}" for k in range(9)], *out):
            scale = b.abs().max().item()
            err = (a - b).abs().max().item()
            torch.testing.assert_close(a, b, rtol=1e-10,
                                       atol=1e-10 * max(scale, 1e-300),
                                       msg=f"{name} {what}")
            if scale > 0 and err / scale > worst[0]:
                worst = (err / scale, f"{name} {what}")
    print(f"[13] {len(names)} residual names, {BREADTH_K} factors each, "
          f"linearized in float64 on the card and on the CPU in "
          f"{time.perf_counter() - t0:.1f} s: residuals and Jacobians agree "
          f"to rtol 1e-10; largest gap {worst[0]:.2e} of the largest entry "
          f"({worst[1]})")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    dev = config.device("cuda")
    card = card_line()
    print(card)
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")
    phase_build()
    record = phase_kernel(dev)
    phase_parity(dev)
    launches = phase_main(dev)
    phase_pose_parity(dev)
    phase_se3_parity(dev)
    batch_optimum = phase_pose_main(dev)
    chain_record = phase_chain(dev)
    data, stream_end = phase_isam_parity(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_checkpoint(dev, data, stream_end, tmp)
        chain_launches = phase_isam_main(dev, batch_optimum)
        phase_file_2d(dev, batch_optimum, tmp)
        phase_file_3d(dev, tmp)
    phase_breadth(dev)
    print(card)
    print(json.dumps({"kernels": [
        {"name": "landmark_block_solve", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
         "launches": launches, **record},
        {"name": "chain_factorize", "route": "cuda",
         "source": CHAIN_SOURCE, "replaces": CHAIN_REPLACES,
         "launches": chain_launches, **chain_record}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
