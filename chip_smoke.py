#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gtsam_personal_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, numbered as in the order they were added; any failure raises and
the script exits non-zero. They run in this order: 1-8, 10-14, 19, 21,
23, 24's optimize_lm_jit, then 16 and 17 beside seven more processes of
this script (`--child parity TMP`: phases 9 and 15, which time nothing;
`--child smart TMP`: phase 18's full-size stream; `--child breadth TMP`:
phase 19's card == CPU checks and phases 20, 22 and 25's card == CPU
checks, which time nothing; `--child comparer TMP`: phase 22's
solver_comparer run; `--child hybrid TMP`: phase 24's hybrid stream;
`--child dist TMP`: phase 26, which spawns its ranks; `--child tools
TMP`: phase 27), then the rest of 18; the
kernels are timed before the other processes start or after they end:
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
     chains at capacity 64, d = 4 at capacity 256 (the kernel's ring of
     tiles wrapped, as d = 3, 6 and 15 wrap above), every d at capacity
     37 (a ragged last tile of the ring), in float64 (1e-10 of the
     largest entry) and float32 (1e-3), and d = 3 at full length
     (capacity 16384, the 10000 poses of phase 7's graph); then
     factorize + chain_apply in float32
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
     1e-10 times the largest entry);
 14. the preintegration kernels (ops/preintegration.py) against their plain
     versions on the card, preint_tangent and preint_rotation in both modes,
     at 2000 segments of 200 samples and on a ragged batch of 1, 37 and 200
     samples: float64 within 1e-10 of the largest entry of each output,
     float32 no further from the float64 plain version than 4 times the
     plain float32's own distance (floor 1e-4 of the largest entry);
     preint_rotation in both modes on one segment of 2000 samples (float64,
     1e-10), and the ragged batch's 37-sample segment equal to itself alone
     bit for bit; the manifold and AHRS entry points launch
     preint_rotation; time per launch (CUDA events around launches from
     the host; the device's from a CUDA graph of launches beside it as
     device_ms), the plain version's and the bound (bytes, operations and
     the dependent chain: preint_tangent's 200 steps, preint_rotation's
     reduction depth), for the batch path's launch and for the stream's
     one segment, preint_rotation in both modes; the two entry points'
     time whole;
 15. the IMU + GPS paths of tools/imu_gps_vio.py on a 20-fix stand-in of
     imuAndGPSdata.csv (write_imu_gps_csv) in float64, card against CPU:
     batch LM error to 1e-9 relative; the ISAM2 stream at the example's
     settings (3 updates a fix) with the same rows relinearized and
     estimates to 1e-8;
 16. the batch path at 2000 fixes (400 000 samples, a 33-minute drive): one
     preint_tangent launch, dead reckoning (the JAX example's start, whose
     drift is printed), partitioned-Schur LM (parts of at most 128) in
     float64 from the GPS-aided start; gates: the error finite and
     decreasing, the mean position error against the stand-in's truth below
     1 m; seconds per step;
 17. the stream at VIO_STREAM_FIXES (500) fixes with the example's settings
     (float64, superchain:se3+vel3+imu_bias, CG 500 at 1e-10,
     relinearization 0.01, 3 updates a fix) but one: the preconditioner is
     rebuilt every update (VIO_STREAM_REFRESH; the engine's default of every
     10 takes CG to its cap in both packages); gates: the final error at
     most 1.05 times the float64 batch optimum of the same graph, mean
     position error below 1 m,
     preint_tangent launched once per fix, chain_factorize launched (at
     d = 15); ms per fix and per update, CG iterations per update, and
     chain_factorize's time at the stream's capacity and d = 15;
 18. smart factors streamed into ISAM2 (tools/isam2_smart_factor.py): the
     JAX example's scene (12 poses, 30 landmarks, T = 4) in float64 with CG
     run to convergence, card against CPU, estimates to 1e-8; then
     SMART_POSES and SMART_LANDMARKS (500 and 2500: five tracks closing per
     pose) with the example's engine defaults and SMART_REFINE_ITERS (10)
     Gauss-Newton steps a triangulation, run by its own process (its ms per
     update, and phases 16-17's times, are taken side by side with it and
     with phases 9 and 15); gates: the error at most 1.05 times
     the batch optimum of the same graph, the aligned ATE rmse below the
     example's bound of 2 m; ms per update. chain_factorize's time at
     phase 17's capacity and d = 15 is taken after that process has ended;
 19. Shonan rotation averaging at full size: the 2500-pose sphere stand-in
     of phase 12 through tools/shonan_averaging_cli.py's run, the staircase
     p = 3..7 in float64 from the opt-in chordal start
     (sfm/shonan.py:chordal_start); seconds, iterations and PCG iterations
     of each level's LM, min_eigenvalue's seconds and ms a power step,
     certified, p, min_eig, the cost, the angular errors against the truth
     (gauge R_0 = I) of the result and of the start, peak memory; gates:
     certified, and the result's rms error at most 1.1 times the start's;
     then one PCG solve, one LM iteration and 50 power steps at p = 3 under
     the profiler (device events a step, busy share), and
     translation_recovery on the sphere's edges with exact directions
     (seconds, error); in the breadth process: the staircase on the first
     100 poses card == CPU (same start and v0; rotations to 1e-8, min_eig
     to 1e-6), translation_recovery card == CPU on 6 positions (1e-9), and
     the JAX example's own start on the full sphere as a record;
 20. the nonlinear breadth card == CPU in float64 on the problems of its
     parity tests (marginals, dogleg, NCG, GNC, constrained, the misc
     factors, the fixed-lag smoother, the incremental smoother on a
     300-pose Manhattan stream, the concurrent filter and smoother), then
     tools/{pose2_slam_example,fixed_lag_smoother,inverse_kinematics,
     tutorials}.py once each on the card;
 21. the multi-level Schur solver (linear/mlschur.py) on phase 7's graph:
     make_ml_plan(max_part_size=256) (host seconds; gate: its stats equal
     the JAX plan's, 3 levels, parts [48, 7, 5], Dmax [768, 624, 681],
     sdmax [1212, 2391, 2388], root 5769); one solve_ml against
     solve_partitioned at lambda 1e-3 (gate in float64: max |difference|
     <= 1e-9 max |step|; float32 printed), each one's ms a call by CUDA
     events around 10 calls after a warm-up, one solve_ml's split by stage
     and the peaks; phase 7's LM run with the MLPlan in float32 and
     float64 (phase 7's gates, and the float64 error equal to phase 7's
     within 1e-9 relative; it/s beside phase 7's); SPCG in float64
     (linear/subgraph.py, cap 200, tolerance 1e-8) at full size (a 30000 x
     30000 dense tree system; its iterations and gap to solve_partitioned
     printed; gate: finite and closer than block-Jacobi PCG at the same
     cap) and at 300 poses (gate: converged inside the cap, within 1e-6 of
     solve_partitioned);
     optimize_lm with solver "sequential" and "qr" against "schur" on a
     2000-pose graph in float64 (gate: the same error to 1e-9 relative);
 22. the linear breadth card == CPU in float64 on the parity tests'
     problems (sequential elimination and the Bayes net's solves, the
     equality-constrained solve, the diagnosis, solve_ml on a 4-level and
     a 0-level plan, SPCG, the Kalman filters, the samplers' deterministic
     parts, the QP on card tensors); in its own process,
     tools/solver_comparer.py on the card on a 2000-pose file of
     write_g2o_2d, every solver and the incremental stream (gates: the
     direct solvers agree to 1e-6 in their parameters; a second run's
     snapshot is within 1e-6 of the first's).

 23. the camera-major BA engine (sfm/ba.py:optimize_ba) on phase 5's
     problem in float32: one warm-up iteration, then CM_ITERS (10) at its
     defaults (lambda0 1e-4, 12 tries an iteration, PCG to 1e-6 or 100
     iterations, its convergence flag read every 8); seconds a try, the
     split by CUDA events (linearize, preconditioner, PCG, error), PCG
     iterations and landmark_block_solve launches a try; gates: finite,
     decreasing, rms < 1.3 px, the kernel launched; the 29-camera float64
     step (lambda 1, CG to 1e-12) and the error after it card == CPU to
     1e-9; then tools/sfm_example_bal.py with both engines (float64,
     CM_ITERS iterations) on a write_bal file of the problem, each
     decreasing;
 24. optimize_lm_jit against optimize_lm (the same Params and plan) on
     phase 7's graph in float64: final errors within 1e-9; then
     tools/hybrid_city10000.py on the stand-in of T1_city10000_04.txt
     (write_city10000_hybrid: phase 7's graph as EDGE2 lines, 62 loop
     closures with a second, wrong candidate): both engines at the
     example's 150 lines card == CPU (modes equal, final error to 1e-9)
     and equal to the stand-in's true modes, then the ISAM2 engine timed
     at HYBRID_TIMED_LINES (500) lines: ms an edge and chain_factorize's
     launches (gate: the true modes, the kernel launched);
 25. the rest of the library card == CPU in float64 (discrete inference,
     the scheduler CSP, Chebyshev fit and matrices, a QPS file's QP,
     keys, symbolic elimination, the Graphviz text; 1e-12), and
     tools/discrete_examples.py on the card, in the breadth process.

 26. the distributed paths (parallel/), in `--child dist TMP`: it spawns
     DIST_RANKS (4) ranks once, all on the one card in a gloo group (their
     all-reduces go through host memory), and runs in them, rank 0
     printing: (a) float64, the ranks against the single-device functions
     on the card: dist_pack_solve_step against solve_ba_step_pk on the
     29-camera problem (CG to 1e-12; gate 1e-8), dist_pack_lm_run against
     ba_lm_run_pk, 5 iterations (lambda 1e-12 relative, error 1e-8
     relative, state 1e-8), dist_solve_ba_step against solve_ba_step_cm
     on the 19-camera ring (1e-8), a world of one (no boundary, 1e-8);
     (b) dist_pack_lm_run on phase 5's problem, float32, lambda0 1e-3,
     cg 2, balanced dealing, a warm-up run of 10 iterations and 10 timed,
     under phase 5's gates and landmark_block_solve launched on every
     rank: it/s, the boundary share and each rank's rows under balanced
     and contiguous dealing, collective_overhead; the main process prints
     the final error beside phase 5's; (c) the sharded partitioned Schur
     solve of phase 7's graph, float64, lambda 1e-3, against
     solve_partitioned (1e-9), ms a call of each and collective_overhead;
     (d) one shard_graph LM step of phase 6's 300-pose graph against the
     single-device step, PCG run to convergence (1e-10), and
     sharded_ba_step against ba_try_step on the 16-camera ring (1e-8).
 27. the seven tools of examples/ that came last (tools/stereo_vo_large,
     victoria_park, range_isam_plaza2, visual_isam2, pose2_m3500,
     view_graph, parity_suite), in `--child tools TMP`: on the card at
     full size on seeded stand-ins of their files (write_tool_data: VO
     at 25 poses, 8189 stereo factors, 4700 landmarks; Victoria Park at
     6970 poses and 151 landmarks, parts <= 256; Plaza2 at 4090 steps and
     1816 ranges; M3500 at 3500 poses with "schur"; every parity-suite
     subcommand), each under the JAX example's own gate, with its
     seconds; visual_isam2 at the example's defaults and timed at
     TOOL_VIS_POSES x TOOL_VIS_POINTS (40 x 32); preint_tangent's
     launches in the parity suite (combined_imu, a launch a keyframe),
     then the kernel against its plain version on those 6 segments
     (float64, 1e-10 of the largest entry); then card == CPU at the parity
     tests' cut sizes (tool_lines_gap, tool_record_gap: float64 errors to
     1e-9 relative, variables to 1e-8; the ISAM2 streams with CG run to
     convergence, ISAM2_CONVERGED).

The last two lines are a JSON record of the kernels ({"kernels": [...]},
each with the launch count from its main path, named in its
`launches_from`; landmark_block_solve adds `launches_dist`, phase 26's;
preint_tangent `launches_tools`, phase 27's) and {"ok": true, "device":
{...}}.
"""

import json
import math
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from gtsam_personal_tpu_torch import config, native
from gtsam_personal_tpu_torch.basis import chebyshev
from gtsam_personal_tpu_torch.core import keys
from gtsam_personal_tpu_torch.discrete import csp, discrete
from gtsam_personal_tpu_torch.inference import symbolic
from gtsam_personal_tpu_torch.io import qps
from gtsam_personal_tpu_torch.utils import dot as dotw
from gtsam_personal_tpu_torch.core.graph import (FactorBatch, FactorGraph,
                                                 GraphBuilder)
from gtsam_personal_tpu_torch.core.values import (Layout, Values, tree_vdot,
                                                  values_from_numpy)
from gtsam_personal_tpu_torch.geometry import se2, se3, so3
from gtsam_personal_tpu_torch.geometry import fundamental as fundamental_mod
from gtsam_personal_tpu_torch.linear import (conditional, diagnostics, kalman,
                                             lpqp, mlschur, sampler, schur,
                                             solvers, subgraph)
from gtsam_personal_tpu_torch.linear import noise as noise_mod
from gtsam_personal_tpu_torch.linear.linearize import (linearize,
                                                       linearize_batch)
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.navigation import preintegration as pre
from gtsam_personal_tpu_torch.navigation import scenario
from gtsam_personal_tpu_torch.nonlinear import (constrained, gnc, isam2,
                                                marginals, misc, optimizers)
from gtsam_personal_tpu_torch.nonlinear.concurrent import (
    ConcurrentFilterSmoother)
from gtsam_personal_tpu_torch.nonlinear.dogleg import (optimize_dogleg,
                                                       optimize_ncg)
from gtsam_personal_tpu_torch.nonlinear.fixed_lag import FixedLagSmoother
from gtsam_personal_tpu_torch.nonlinear.incremental import (
    IncrementalSmoother)
from gtsam_personal_tpu_torch.ops import _build, chain
from gtsam_personal_tpu_torch.ops import preintegration as preint_ops
from gtsam_personal_tpu_torch.ops.block_solve import (
    landmark_block_solve, landmark_block_solve_ref)
from gtsam_personal_tpu_torch.ops.chain import chain_factorize
from gtsam_personal_tpu_torch.parallel import (ba_sharded, bootstrap, dist_ba,
                                               dist_ba_pack, dist_schur)
from gtsam_personal_tpu_torch.parallel import mesh as pmesh
from gtsam_personal_tpu_torch.sfm import (averaging, ba, ba_pack, bal,
                                          shonan, synthetic)
from gtsam_personal_tpu_torch.slam import (dataset, factors as F, initialize,
                                           manhattan, metrics)
from gtsam_personal_tpu_torch.tools import factor_samples, profile_isam2
from gtsam_personal_tpu_torch.tools import fixed_lag_smoother as fixed_lag_tool
from gtsam_personal_tpu_torch.tools import imu_gps_vio as vio
from gtsam_personal_tpu_torch.tools import inverse_kinematics as ik_tool
from gtsam_personal_tpu_torch.tools import pose2_slam_example as pose2_tool
from gtsam_personal_tpu_torch.tools import shonan_averaging_cli as shonan_cli
from gtsam_personal_tpu_torch.tools import solver_comparer as comparer_tool
from gtsam_personal_tpu_torch.tools import tutorials as tutorials_tool
from gtsam_personal_tpu_torch.tools import discrete_examples as discrete_tool
from gtsam_personal_tpu_torch.tools import hybrid_city10000 as hybrid_tool
from gtsam_personal_tpu_torch.tools import sfm_example_bal as sfm_tool
from gtsam_personal_tpu_torch.tools import isam2_smart_factor as smart_tool
from gtsam_personal_tpu_torch.tools import (parity_suite, pose2_m3500,
                                            range_isam_plaza2,
                                            stereo_vo_large, victoria_park,
                                            view_graph, visual_isam2)
from gtsam_personal_tpu_torch.utils import serialization
from gtsam_personal_tpu_torch.tools.profile_isam2 import (
    ISAM_N, ISAM_PARAMS, ISAM_UPDATE_EVERY)
from gtsam_personal_tpu_torch.tools.profile_pose_graph import (
    POSE_ITERS, POSE_LAM0, POSE_N, POSE_PART, device_ms, device_ms_per_call)

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
# the dependent chain of one block of chain_factorize, a model (see
# chain_bound), from the latencies that tools/kernel_probes.py measured on
# the H100, in cycles at CLOCK_HZ, by item size in bytes: (FMA, reciprocal),
# the reciprocal as the kernel takes it, rcp.approx and one Newton step (2
# FMAs) in float32, two (4 FMAs) in float64; the probe's "rcp.approx + fma"
# is 23.2 and 27.1 cycles, its fma 4.46 and 8.82
CHAIN_LATENCY = {4: (4.46, 23.2 + 4.46), 8: (8.82, 27.1 + 3 * 8.82)}
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
# phases 14-18: the preintegration kernels, the IMU + GPS paths, smart
# factors
PREINT_T_SOURCE = "gtsam_personal_tpu_torch/csrc/preint_tangent.cu"
PREINT_T_REPLACES = "gtsam_personal_tpu/navigation/preintegration.py:112"
PREINT_R_SOURCE = "gtsam_personal_tpu_torch/csrc/preint_rotation.cu"
PREINT_R_REPLACES = "gtsam_personal_tpu/navigation/preintegration.py:171"
PREINT_S, PREINT_N = 2000, 200      # the batch path's launch: 2000 fixes
# one AHRS window of 10 s at 200 Hz: preint_rotation's rounds of 256 samples
# carried 8 times
PREINT_LONG = 2000
# NVIDIA's H100 SXM data sheet: float64 on the tensor cores, the card's
# highest float64 rate. Scalar float64 FMAs peak at about 33.5e12 (132 SMs x
# 64 FMAs x 2 x 1.98 GHz), so a kernel of scalar arithmetic reaches at most
# about half of the bound this rate gives
FP64_FLOP_PER_S = 67e12
# operations of one sample as the step's structure needs them. preint_tangent:
# A = d zeta+/d zeta is the identity but for its theta column (three 3 x 3
# blocks) and dt I in its p-v block, B has 6 non-zero rows and C 3, so
# A cov A^T takes 933 (A cov 594, then the 45 entries of the symmetric
# result 339), the B and C terms 270 (R Sa R^T and Jl Sg Jl^T and their
# scaled sums), Si dt 12, A H - [B | C] 423, the step's coefficients and
# their derivatives about 300; preint_rotation in manifold mode: the primal
# about 250, each of 6 tangents about 300; in AHRS mode: the primal about
# 155 (Exp about 110, R E 45), each of 3 tangents about 200 (dE about 95,
# dR E + R dE 105), the covariance step about 245 (Jl dt 45, Sg / dt 10,
# J S J^T 90, E^T cov E 90, + Q 9)
TANGENT_FLOPS, ROTATION_FLOPS, AHRS_FLOPS = 1938, 2050, 1000
# the dependent chain of preint_tangent's step, in cycles at the card's
# 1.98 GHz boost clock: float64 FMAs take 8 cycles, a division or a square
# root about 40. theta+ needs |theta|^2 (3 FMAs), a square root and a
# division, sin and cos (an 8-term polynomial) and Jl^-1 w dt (3 FMAs and
# an add): 15 x 8 + 2 x 40 = 200; the covariance's chain (10 FMAs through
# A cov and (A cov) A^T) is shorter and runs beside it
TANGENT_STEP_CYCLES = 200
CLOCK_HZ = 1.98e9
# preint_rotation's scan is a product of per-sample elements under an
# associative composition, so its least dependent depth is one element and
# ceil(log2 N) combines, in kernel_probes' float64 latencies (cycles): an
# element is |phi|^2 (phi = w dt, then 3 FMAs), a square root, x / pi and
# sincospi, then Exp's coefficients, their derivatives and the element's
# 3 x 3 entries (8 FMAs; the reciprocal runs beside sincospi); a combine is
# a 3 x 3 product (3 FMAs) and the product rule's add
FMA64_CYCLES, SQRT64_CYCLES, SINCOSPI64_CYCLES = 8.82, 89.3, 195.5
ELEMENT_CYCLES = 13 * FMA64_CYCLES + SQRT64_CYCLES + SINCOSPI64_CYCLES
COMBINE_CYCLES = 4 * FMA64_CYCLES
# phase 17 streams the first 500 fixes (100 000 samples, 8 minutes of
# driving); phase 15's 20 fixes are the small stand-in of both paths
VIO_SMALL, VIO_BATCH_FIXES, VIO_STREAM_FIXES = 20, 2000, 500
# phase 17 rebuilds the stream's preconditioner every update: with the
# engine's default of every 10 updates (the JAX example's, which phase 15
# and tests/test_torch_vio.py keep), updates 2 and 3 of a fix run CG with
# the preconditioner built before the moved states were relinearized, and
# CG climbs to its cap of 500 by fix 40; the JAX example's own stream does
# the same on the CPU (its cap by fix 43 of a 50-fix stand-in), and at
# that cap 500 fixes do not fit the script's time
VIO_STREAM_REFRESH = 1
# phase 18's full-size stream, run by its own process of this script beside
# phases 16-17 and the parity process (one process for all of them took
# 818 s of the 1200 allowed on a host of middling load): the JAX example's
# circle at 500 poses and 2500 landmarks
# (five tracks closing per pose) with the example's engine defaults
# (block-Jacobi, CG cut at 25 iterations or 1e-4 of the entry residual,
# relinearization 0.01, two updates a pose). Its smart factors take
# SMART_REFINE_ITERS Gauss-Newton steps in their triangulation, not the
# example's 3 (make_smart_residual's argument in both packages): at 500
# poses a track spans 2.2 degrees of the circle, 3 steps leave a few tracks
# far from their minimum (the smart error at the true poses is 41973 with
# 3 steps, 5915 with 10 or more), and then neither the JAX example's stream
# nor its batch LM comes near the truth (PERF.md §6; ROADMAP queue 3)
SMART_POSES, SMART_LANDMARKS, SMART_REFINE_ITERS = 500, 2500, 10
# the trajectory's gate: the aligned ATE rmse (slam/metrics.ate, as phases
# 7, 10 and 12 take it) below the example's bound of 2 m on its mean
# position error; unaligned, the batch optimum itself is 2.15 m off at 500
# poses (a chain held by one prior drifts as a whole), so that figure is
# printed beside it
SMART_ATE_BOUND = 2.0
CHILD_TIMEOUT = 900     # seconds the script waits for each child process

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


def _time_ms(fn, n=200, warmup=10):
    """Mean milliseconds per call over n calls after `warmup` calls, by
    CUDA events: for a kernel of a few microseconds this is the host's
    launch path, not the kernel."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _graph_ms(fn, k=20, reps=10):
    """Device milliseconds per call of fn(), the host's launch path left
    out: k calls captured in a CUDA graph (the kernels' wrappers launch on
    the current stream, which the capture records), the graph replayed
    `reps` times between two CUDA events after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * k)


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
    run and its final error."""
    t0 = time.perf_counter()
    prob, state, obs = _ladybug(torch.float32, dev)
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
    return launches, err_final


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
    float64 error, the batch optimum that phase 10 is held to, and the it/s
    of the three timed runs by dtype name."""
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
        runs[name] = (float(err0), float(err), ate,
                      [iters / dt for dt in dts[1:]])
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
    e0, e32, ate32, _ = runs["float32"]
    _, e64, ate64, _ = runs["float64"]
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
    return e64, {name: r[3] for name, r in runs.items()}


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
    """(bound_ms, bound_by, what) of one chain factorization: the largest of
    its bytes (D and O read, Uinv written, each once) over the HBM rate, its
    operations (per block two d^3 products and a d^3 inverse, 2 flop each)
    over the float32 rate, and cap steps of the dependent chain, a model
    in CHAIN_LATENCY's cycles: T = Uinv O and A = D - O^T T are d FMAs deep
    each; for d <= 4 the adjugate then takes a cofactor (2 deep), the
    determinant (3 deep at d = 3, 6 at d = 4), one reciprocal and the
    scaling multiply; for d > 4 elimination takes d pivots of a reciprocal
    and an FMA. The chain's steps are operations, so it is `bound_by`
    "operations" too."""
    by_bytes = 3 * cap * d * d * itemsize / HBM_BYTES_PER_S * 1e3
    by_ops = 6 * d ** 3 * cap / FP32_FLOP_PER_S * 1e3
    fma, rcp = CHAIN_LATENCY[itemsize]
    if d <= 4:
        step = (2 * d + 2 + {3: 3, 4: 6}[d] + 1) * fma + rcp
    else:
        step = 2 * d * fma + d * (rcp + fma)
    by_chain = cap * step / CLOCK_HZ * 1e3
    terms = {"bytes": by_bytes, "operations": by_ops,
             "dependent-chain model": by_chain}
    what = max(terms, key=terms.get)
    return terms[what], ("bytes" if what == "bytes" else "operations"), (
        f"bytes {by_bytes * 1e3:.2f} us, operations {by_ops * 1e3:.2f} us, "
        f"dependent-chain model {by_chain * 1e3:.2f} us: {what}")


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
        # 8 tiles: the kernel's ring of 4 wraps twice
        check("d=4, seeded SPD chain, cap 256, all active",
              *_spd_chain(4, 256, dev, 4), 256, dtype)
        check("d=15, seeded SPD chain, cap 64, 37 active",
              *_spd_chain(15, 64, dev, 15), 37, dtype)
        for d in chain.CHAIN_BLOCK_SIZES:   # a ragged last tile
            check(f"d={d}, seeded SPD chain, cap 37, all active",
                  *_spd_chain(d, 37, dev, d), 37, dtype)
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
        bound_ms, bound_by, what = chain_bound(CHAIN_CAP, d, 4)
        print(f"[8] chain_factorize float32 cap {CHAIN_CAP} d={d}: "
              f"{ms:.4f} ms per call (CUDA events, 20 calls; torch.profiler "
              f"{p_ms / p_n:.4f} ms per kernel event, {20 * p_n:g} of 20 "
              f"recorded), {ms / CHAIN_CAP * 1e6:.1f} ns per block; bound "
              f"{bound_ms * 1e3:.2f} us ({what}), "
              f"{100 * bound_ms / ms:.2f}% of the kernel's time")
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
                   "bound_model": what, "library_ms": None}
    return rec


# Phase 9's CG runs to convergence (at most 117 iterations on the CPU):
# cut at 1e-10 (at most 107) it ends 7.4e-13 from convergence, so two
# streams whose sums differ in order and stop an iteration apart left the
# checkpoint's 1e-12 gate (1.01e-12 once, 7.73e-13 once on the H100)
ISAM_SMALL_CG = {"cg_maxiter": 300, "cg_tol": 1e-14}


def _isam_small(dev, data):
    """The small float64 stream of phase 9 through an engine on `dev`:
    update records, then 20 poses marginalized and two more updates."""
    isam = profile_isam2.make_engine(data, device=dev, dtype=torch.float64,
                                     **ISAM_SMALL_CG)
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
          f"chain:se2, CG to {ISAM_SMALL_CG['cg_tol']:g}; 20 poses "
          f"marginalized; chain_factorize.launches on the card = {launches}")
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
                                     **ISAM_SMALL_CG)
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


# the stand-in of T1_city10000_04.txt (phase 24): phase 7's 10000-pose
# Manhattan world, every edge a line `EDGE2 keyS 1 keyT 1 numMeas x y rad
# [x y rad]` ordered by target pose, odometry first; HYBRID_AMBIGUOUS of the
# loop closures (the first 3, then a seeded spread; the real file has 62)
# carry a second candidate, the true measurement composed with an offset of
# HYBRID_WRONG (signs seeded), in a seeded order
HYBRID_AMBIGUOUS = 62
HYBRID_WRONG = np.array([1.5, 1.0, 0.4])


def write_city10000_hybrid(path, seed=0):
    """Write the stand-in; returns the true mode of each mode variable,
    {1000 + k: index of the true candidate of the k-th ambiguous line}."""
    graph, _, _ = manhattan.make_manhattan(POSE_N, seed=42, device="cpu",
                                           dtype=torch.float64)
    (b,) = [b for b in graph.batches if b.name == "between_se2"]
    idx, meas = b.idx.numpy(), b.meas["measured"].numpy()
    order = np.lexsort((idx[:, 1] - idx[:, 0] > 1, idx[:, 1]))
    closures = [k for k in order if idx[k, 1] - idx[k, 0] > 1]
    rng = np.random.default_rng(seed)
    amb = closures[:3] + list(rng.choice(closures[3:], HYBRID_AMBIGUOUS - 3,
                                         replace=False))
    amb = set(int(k) for k in amb)
    modes, lines = {}, []
    for k in order:
        cands = [meas[k]]
        if k in amb:
            off = HYBRID_WRONG * rng.choice([-1.0, 1.0], 3)
            wrong = se2.compose(torch.tensor(meas[k]),
                                torch.tensor(off)).numpy()
            true_mode = int(rng.integers(2))
            cands = [wrong, wrong]
            cands[true_mode] = meas[k]
            modes[1000 + len(modes)] = true_mode
        lines.append(f"EDGE2 {idx[k, 0]} 1 {idx[k, 1]} 1 {len(cands)} "
                     + " ".join(f"{x:.9f} {y:.9f} {t:.9f}"
                                for x, y, t in cands))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return modes


# the stand-in of examples/Data/imuAndGPSdata.csv: a car at 10 m/s turning
# at 0.05 rad/s, 200 IMU samples per GPS fix, the example's imuParams()
VIO_OMEGA, VIO_VEL = np.array([0.0, 0.0, 0.05]), np.array([10.0, 0.0, 0.0])
VIO_ACC_SIGMA, VIO_GYRO_SIGMA = 0.0003924, 0.000205689024915
VIO_BIAS_ACC_SIGMA, VIO_BIAS_GYRO_SIGMA = 0.004905, 0.000001454441043
VIO_GPS_SIGMA = 1.0
# the constant part of the IMU's bias: accelerometer 1e-3 m/s^2 (the bias
# prior's sigma), gyro 1e-5 rad/s
VIO_BIAS0_SIGMAS = np.r_[np.full(3, 1e-3), np.full(3, 1e-5)]


def _rot_to_quat(R):
    """(qx, qy, qz, qw) of rotation matrices [n, 3, 3] (numpy)."""
    w = 0.5 * np.sqrt(np.maximum(1.0 + np.trace(R, axis1=1, axis2=2), 0.0))
    w = np.maximum(w, 1e-12)
    return np.stack([(R[:, 2, 1] - R[:, 1, 2]) / (4 * w),
                     (R[:, 0, 2] - R[:, 2, 0]) / (4 * w),
                     (R[:, 1, 0] - R[:, 0, 1]) / (4 * w), w], 1)


def write_imu_gps_csv(path, n_fixes, seed, samples_per_fix=200):
    """Write a seeded stand-in of the reference's imuAndGPSdata.csv in its
    row format (tools/imu_gps_vio.py:load_imu_gps_csv) and the truth beside
    it as `<path>.truth.npz` (positions, rotations, velocities at the fixes,
    the biases of every sample); returns the truth's positions [n, 3].

    The vehicle follows ConstantTwistScenario(VIO_OMEGA, VIO_VEL); the IMU
    has gravity removed, as the file's has, and carries white noise of the
    example's sigmas over sqrt(dt), a constant bias (VIO_BIAS0_SIGMAS) and a
    random walk at the bias sigmas. A GPS fix, sigma 1 m per axis, follows
    every `samples_per_fix` samples."""
    rng = np.random.default_rng(seed)
    dt = vio.DT
    N = n_fixes * samples_per_fix
    scen = scenario.ConstantTwistScenario(VIO_OMEGA, VIO_VEL)
    acc_true = np.cross(VIO_OMEGA, VIO_VEL)
    walk = np.cumsum(rng.normal(size=(N, 6)) * np.sqrt(dt) * np.r_[
        np.full(3, VIO_BIAS_ACC_SIGMA), np.full(3, VIO_BIAS_GYRO_SIGMA)], 0)
    bias = rng.normal(size=6) * VIO_BIAS0_SIGMAS + walk
    imu = (np.r_[acc_true, VIO_OMEGA] + bias
           + rng.normal(size=(N, 6)) / np.sqrt(dt) * np.r_[
               np.full(3, VIO_ACC_SIGMA), np.full(3, VIO_GYRO_SIGMA)])
    t_fix = (np.arange(n_fixes) + 1) * samples_per_fix * dt
    nav_t = scen.nav_state(t_fix).numpy()
    pos, rot, vel = nav_t[:, :, 3], nav_t[:, :, :3], nav_t[:, :, 4]
    gps = pos + rng.normal(scale=VIO_GPS_SIGMA, size=pos.shape)
    quat = _rot_to_quat(rot)
    v0 = scen.nav_state(0.0).numpy()[:, 4]
    fmt = "{:.17g}".format
    with open(path, "w") as f:
        f.write("i,0,0,0,0,0,0,1," + ",".join(map(fmt, v0)) + "\n")
        for k in range(n_fixes):
            rows = imu[k * samples_per_fix:(k + 1) * samples_per_fix]
            f.write("".join("0," + ",".join(map(fmt, r)) + "\n"
                            for r in rows))
            f.write("1," + ",".join(map(fmt, np.r_[gps[k], quat[k]]))
                    + "\n")
    np.savez(f"{path}.truth.npz", positions=pos, rotations=rot,
             velocities=vel, bias=bias)
    return pos


# the stand-ins of phase 27's data files: the counts are the JAX examples'
# (their docstrings and comments), the scenes seeded
VO_POSES, VO_FACTORS, VO_LANDMARKS = 25, 8189, 4700
VO_CAL = np.array([700.0, 700.0, 0.0, 640.0, 360.0, 0.5])  # fx fy s u0 v0 b
VO_PIXEL_SIGMA = 0.5


def _fmt_rows(rows):
    return "".join(" ".join(f"{x:.17g}" for x in r) + "\n" for r in rows)


def write_vo_large(dir, seed=0, n_poses=VO_POSES, n_factors=VO_FACTORS,
                   n_landmarks=VO_LANDMARKS):
    """Write seeded stand-ins of the reference's VO_calibration.txt,
    VO_camera_poses_large.txt and VO_stereo_factors_large.txt into `dir`;
    returns the true poses [n, 3, 4] and landmarks [m, 3].

    The counts are examples/stereo_vo_large.py:3-5's: 25 poses, 8189
    stereo factors, ~4700 landmarks (4700 here). A stereo camera (VO_CAL,
    baseline 0.5 m) drives 1 m a frame along a gentle curve; each landmark
    is seen by 1-3 consecutive frames (track lengths fixed by the counts),
    6-40 m ahead of its first. A factor line is `pose_id landmark_id uL uR
    v X Y Z`: the pixels with VO_PIXEL_SIGMA noise and X Y Z their
    camera-frame triangulation, as the recorded file has it. The pose
    lines (`id` and the 4x4 wTc row-major) are the truth perturbed by
    0.002 rad and 0.02 m, the first exact."""
    rng = np.random.default_rng(seed)
    fx, fy, _, u0, v0, b = VO_CAL
    yaw = 0.02 * np.arange(n_poses)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.zeros((n_poses, 3, 3))       # about the camera's y (down) axis
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1] = c, s, 1.0
    R[:, 2, 0], R[:, 2, 2] = -s, c
    t = np.concatenate([np.zeros((1, 3)), np.cumsum(R[:-1, :, 2], 0)])
    extra = n_factors - n_landmarks
    n3 = max(extra // 6, extra - n_landmarks)
    n2 = extra - 2 * n3
    lengths = rng.permutation(np.r_[np.ones(n_landmarks - n2 - n3, int),
                                    np.full(n2, 2), np.full(n3, 3)])
    first = rng.integers(0, n_poses - lengths + 1)
    Z = rng.uniform(6.0, 40.0, n_landmarks)
    pc0 = np.stack([rng.uniform(-0.7, 0.7, n_landmarks) * Z,
                    rng.uniform(-0.25, 0.25, n_landmarks) * Z, Z], 1)
    pts = np.einsum("nij,nj->ni", R[first], pc0) + t[first]
    lm_ids = 10000 + rng.permutation(n_landmarks)
    obs_l = np.repeat(np.arange(n_landmarks), lengths)
    obs_x = first[obs_l] + (np.arange(len(obs_l))
                            - np.repeat(np.cumsum(lengths) - lengths,
                                        lengths))
    order = np.lexsort((rng.random(len(obs_l)), obs_x))
    obs_l, obs_x = obs_l[order], obs_x[order]
    pc = np.einsum("nji,nj->ni", R[obs_x], pts[obs_l] - t[obs_x])
    assert pc[:, 2].min() > 1.0
    uv = np.stack([fx * pc[:, 0] / pc[:, 2] + u0,
                   fx * (pc[:, 0] - b) / pc[:, 2] + u0,
                   fy * pc[:, 1] / pc[:, 2] + v0], 1)
    uv += rng.normal(scale=VO_PIXEL_SIGMA, size=uv.shape)
    Zm = fx * b / (uv[:, 0] - uv[:, 1])
    xyz = np.stack([(uv[:, 0] - u0) * Zm / fx, (uv[:, 2] - v0) * Zm / fy,
                    Zm], 1)
    dR = so3.expmap(torch.tensor(rng.normal(scale=0.002,
                                            size=(n_poses, 3)))).numpy()
    Rf = np.einsum("nij,njk->nik", R, dR)
    tf = t + rng.normal(scale=0.02, size=t.shape)
    Rf[0], tf[0] = R[0], t[0]
    mats = np.zeros((n_poses, 4, 4))
    mats[:, :3, :3], mats[:, :3, 3], mats[:, 3, 3] = Rf, tf, 1.0
    with open(os.path.join(dir, "VO_calibration.txt"), "w") as f:
        f.write(_fmt_rows([VO_CAL]))
    with open(os.path.join(dir, "VO_camera_poses_large.txt"), "w") as f:
        f.write(_fmt_rows(np.c_[np.arange(1, n_poses + 1),
                                mats.reshape(n_poses, 16)]))
    with open(os.path.join(dir, "VO_stereo_factors_large.txt"), "w") as f:
        f.write(_fmt_rows(np.c_[obs_x + 1, lm_ids[obs_l], uv, xyz]))
    return np.concatenate([R, t[:, :, None]], 2), pts


# victoria_park.txt: ~6970 poses and 151 landmarks in one id space, ~21k
# tangent dimensions (examples/victoria_park.py:7-9, :118-120)
VICTORIA_POSES, VICTORIA_LANDMARKS = 6970, 151
VICTORIA_ODO_SIGMAS = np.array([0.02, 0.01, 0.002])     # x, y, theta
VICTORIA_V1 = 0.04          # LANDMARK x-variance: range std 0.2 m


def write_victoria_park(path, seed=0, n_poses=VICTORIA_POSES,
                        n_landmarks=VICTORIA_LANDMARKS):
    """Write a seeded stand-in of the reference's victoria_park.txt;
    returns the true poses [n, 3] and landmarks [m, 2].

    A car drives n_poses steps of 0.5 m through a park of radius ~70 m,
    steering back towards its middle; n_landmarks trees stand 5-20 m from
    seeded poses of the drive. At each pose, with probability 0.5, it
    sights one tree in range (< 25 m, in front), and every tree is sighted
    from the pose it was placed from. Lines in time order: `LANDMARK pose
    id x y` (local x y from a bearing and range with std sqrt(V1 / 10)
    and sqrt(V1), the covariance `V1 0 V1`), then `ODOMETRY i j dx dy dth`
    (the true relative pose with VICTORIA_ODO_SIGMAS noise) and its
    upper-triangular covariance (xx xy xt yy yt tt). Poses and trees share
    one id space, trees at seeded ids: the ids odometry never touches, as
    in the reference's file (examples/victoria_park.py:7-9)."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((n_poses, 3))
    for i in range(1, n_poses):
        x, y, th = truth[i - 1]
        away = np.hypot(x, y) - 55.0
        back = np.arctan2(-y, -x) - th
        steer = 0.03 * np.sin(0.004 * i) + 0.01 * np.clip(away, 0, 30) / 30 \
            * np.sign(np.sin(back)) + rng.normal(scale=0.01)
        th = th + steer
        truth[i] = [x + 0.5 * np.cos(th), y + 0.5 * np.sin(th), th]
    T = torch.tensor(truth)
    odo = se2.between(T[:-1], T[1:]).numpy()
    odo += rng.normal(size=odo.shape) * VICTORIA_ODO_SIGMAS
    anchor = np.sort(rng.choice(n_poses, n_landmarks, replace=False))
    rr, bb = rng.uniform(5, 20, n_landmarks), rng.uniform(-1, 1, n_landmarks)
    lms = se2.transform_from(T[anchor], torch.tensor(
        np.stack([rr * np.cos(bb), rr * np.sin(bb)], 1))).numpy()
    sight = [[] for _ in range(n_poses)]
    for j, i in enumerate(anchor):
        sight[i].append(j)
    local = se2.transform_to(T[:, None, :], torch.tensor(lms)[None]).numpy()
    dist = np.linalg.norm(local, axis=2)
    visible = (dist < 25.0) & (local[:, :, 0] > 0)
    pick = rng.random(n_poses) < 0.5
    choice = rng.random(n_poses)
    for i in np.where(pick)[0]:
        vis = np.where(visible[i])[0]
        if len(vis):
            j = vis[int(choice[i] * len(vis))]
            if j not in sight[i]:
                sight[i].append(j)
    ids = np.arange(n_poses + n_landmarks)
    lm_id = np.sort(rng.choice(ids[1:], n_landmarks, replace=False))
    pose_id = np.setdiff1d(ids, lm_id)
    bstd, rstd = np.sqrt(VICTORIA_V1 / 10), np.sqrt(VICTORIA_V1)
    cov6 = np.r_[VICTORIA_ODO_SIGMAS[0] ** 2, 0, 0,
                 VICTORIA_ODO_SIGMAS[1] ** 2, 0, VICTORIA_ODO_SIGMAS[2] ** 2]
    lines = []
    for i in range(n_poses):
        for j in sight[i]:
            bear = np.arctan2(local[i, j, 1], local[i, j, 0]) \
                + rng.normal(scale=bstd)
            rng_m = dist[i, j] + rng.normal(scale=rstd)
            lines.append(f"LANDMARK {pose_id[i]} {lm_id[j]} "
                         f"{rng_m * np.cos(bear):.17g} "
                         f"{rng_m * np.sin(bear):.17g} "
                         f"{VICTORIA_V1:.17g} 0 {VICTORIA_V1:.17g}")
        if i + 1 < n_poses:
            lines.append(f"ODOMETRY {pose_id[i]} {pose_id[i + 1]} "
                         + " ".join(f"{v:.17g}" for v in odo[i]) + " "
                         + " ".join(f"{v:.17g}" for v in cov6))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return truth, lms


# Plaza2_DR.txt / Plaza2_TD.txt: 4090 odometry steps, 1816 ranges to 4
# beacons (examples/range_isam_plaza2.py:3-8)
PLAZA2_STEPS, PLAZA2_RANGES = 4090, 1816
PLAZA2_BEACONS = np.array([[-55.0, 5.0], [-5.0, 5.0], [-5.0, 55.0],
                           [-55.0, 55.0]])
PLAZA2_BEACON_IDS = np.array([0, 1, 6, 7])
PLAZA2_POSE0 = np.array([-34.2086489999201, 45.3007639991120,
                         np.pi - 2.021089])


def write_plaza2(dir, seed=0, n_steps=PLAZA2_STEPS, n_ranges=PLAZA2_RANGES):
    """Write seeded stand-ins of the reference's Plaza2_DR.txt (rows `t
    delta_distance delta_heading`) and Plaza2_TD.txt (rows `t 2 beacon
    range`) into `dir`; returns the true poses [n_steps + 1, 3].

    A robot starts at the example's first pose and drives 0.3 m every 0.2
    s through a 50 m square, steering back towards its middle; its
    odometry carries noise of 0.01 m and 0.002 rad a step. The ranges
    (noise 0.1 m) are taken at seeded times to one of the four beacons
    PLAZA2_BEACONS (ids PLAZA2_BEACON_IDS), each from the pose the
    example's loop attaches it to: the first whose DR time is not
    earlier."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((n_steps + 1, 3))
    truth[0] = PLAZA2_POSE0
    dist = np.full(n_steps, 0.3)
    dhead = np.zeros(n_steps)
    center = PLAZA2_BEACONS.mean(0)
    for i in range(n_steps):
        x, y, th = truth[i]
        away = np.hypot(x - center[0], y - center[1]) - 15.0
        back = np.arctan2(center[1] - y, center[0] - x) - th
        dhead[i] = 0.04 * np.sin(0.01 * i) + 0.03 * np.clip(away, 0, 10) \
            / 10 * np.sign(np.sin(back)) + rng.normal(scale=0.01)
        truth[i + 1] = se2.compose(torch.tensor(truth[i]), torch.tensor(
            [dist[i], 0.0, dhead[i]])).numpy()
    t = 100.0 + 0.2 * np.arange(1, n_steps + 1)
    dr = np.c_[t, dist + rng.normal(scale=0.01, size=n_steps),
               dhead + rng.normal(scale=0.002, size=n_steps)]
    td_t = np.sort(rng.uniform(t[0] - 0.1, t[-1], n_ranges))
    pose = 1 + np.searchsorted(t, td_t)     # the first step with t >= td_t
    beacon = rng.integers(0, len(PLAZA2_BEACONS), n_ranges)
    rng_m = np.linalg.norm(truth[pose, :2] - PLAZA2_BEACONS[beacon], axis=1)
    td = np.c_[td_t, np.full(n_ranges, 2.0), PLAZA2_BEACON_IDS[beacon],
               rng_m + rng.normal(scale=0.1, size=n_ranges)]
    with open(os.path.join(dir, "Plaza2_DR.txt"), "w") as f:
        f.write(_fmt_rows(dr))
    with open(os.path.join(dir, "Plaza2_TD.txt"), "w") as f:
        f.write(_fmt_rows(td))
    return truth


def write_noisy_toy_graph(path, seed=0):
    """Write a stand-in of the reference's noisyToyGraph.txt with
    slam/dataset.py:write_g2o_2d: 9 poses around a 4 m square (2 m steps,
    a left turn after every second), odometry and two closures, (8, 0)
    and (6, 2), with noise of (0.1 m, 0.1 m, 0.05 rad), the vertices the
    composed noisy odometry. The parity suite's `lago` reads it with the
    AUTO noise format (ROADMAP queue 3 C6), as the JAX subcommand does."""
    rng = np.random.default_rng(seed)
    n, sigmas = 9, (0.1, 0.1, 0.05)
    truth = np.zeros((n, 3))
    for i in range(1, n):
        step = np.array([2.0, 0.0, np.pi / 2 if i % 2 == 0 else 0.0])
        truth[i] = se2.compose(torch.tensor(truth[i - 1]),
                               torch.tensor(step)).numpy()
    T = torch.tensor(truth)
    edges = [(i, i + 1) for i in range(n - 1)] + [(8, 0), (6, 2)]
    ij = torch.tensor(edges)
    meas = se2.between(T[ij[:, 0]], T[ij[:, 1]]).numpy()
    meas += rng.normal(size=meas.shape) * np.asarray(sigmas)
    verts = [truth[0]]
    for m in meas[:n - 1]:
        verts.append(se2.compose(torch.tensor(verts[-1]),
                                 torch.tensor(m)).numpy())
    gb = GraphBuilder()
    for (i, j), m in zip(edges, meas):
        F.add_between(gb, "se2", i, j, m, F.diag_noise(sigmas))
    dataset.write_g2o_2d(path, values_from_numpy(
        {"se2": np.stack(verts)}, device="cpu", dtype=torch.float64),
        gb.build(device="cpu", dtype=torch.float64))
    return truth


def write_pose3_example(path, seed=0):
    """Write a stand-in of the reference's pose3example.txt with
    slam/dataset.py:write_g2o_3d: 5 poses (the file's count, SKILL.md) on
    a loop, odometry and one closure with noise of (0.05 rad, 0.1 m), the
    vertices the composed noisy odometry, as VERTEX_SE3:QUAT /
    EDGE_SE3:QUAT lines."""
    rng = np.random.default_rng(seed)
    n, sig = 5, np.r_[np.full(3, 0.05), np.full(3, 0.1)]
    ang = 2 * np.pi * np.arange(n) / n
    Rz = so3.expmap(torch.tensor(np.stack([np.zeros(n), np.zeros(n), ang +
                                           np.pi / 2], 1))).numpy()
    pos = np.stack([3 * np.cos(ang), 3 * np.sin(ang), 0.3 * np.sin(2 * ang)],
                   1)
    T = torch.tensor(np.concatenate([Rz, pos[:, :, None]], 2))
    edges = [(i, i + 1) for i in range(n - 1)] + [(n - 1, 0)]
    ij = torch.tensor(edges)
    meas = se3.compose(se3.between(T[ij[:, 0]], T[ij[:, 1]]), se3.expmap(
        torch.tensor(rng.normal(size=(len(edges), 6)) * sig))).numpy()
    verts = [T[0].numpy()]
    for m in meas[:n - 1]:
        verts.append(se3.compose(torch.tensor(verts[-1]),
                                 torch.tensor(m)).numpy())
    gb = GraphBuilder()
    for (i, j), m in zip(edges, meas):
        F.add_between(gb, "se3", i, j, m, F.diag_noise(sig))
    dataset.write_g2o_3d(path, values_from_numpy(
        {"se3": np.stack(verts)}, device="cpu", dtype=torch.float64),
        gb.build(device="cpu", dtype=torch.float64), fmt="quat")
    return T.numpy()


def write_tool_data(dir, seed=0, **vo):
    """All eight stand-ins of phase 27 in `dir` (the full-size ones unless
    `vo` cuts the VO files: write_vo_large's keywords)."""
    write_vo_large(dir, seed, **vo)
    write_victoria_park(os.path.join(dir, "victoria_park.txt"), seed)
    write_plaza2(dir, seed)
    write_noisy_toy_graph(os.path.join(dir, "noisyToyGraph.txt"), seed)
    write_pose3_example(os.path.join(dir, "pose3example.txt"), seed)


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


def _preint_inputs(lengths, dtype, dev, seed):
    """accs, gyros [S, N, 3], dts [S, N], bias [S, 6] of IMU segments of the
    given lengths (padded with dt = 0), turning at about 0.3 rad/s."""
    rng = np.random.default_rng(seed)
    segs = [np.concatenate([rng.normal(size=(n, 3)) + [0.0, 0.0, 9.81],
                            0.3 * rng.normal(size=(n, 3))], 1)
            for n in lengths]
    accs, gyros, dts = pre.pad_segments(segs, vio.DT, device=dev,
                                        dtype=dtype)
    bias = torch.tensor(0.01 * rng.normal(size=(len(lengths), 6)),
                        device=dev, dtype=dtype)
    return accs, gyros, dts, bias


def _preint_covs(dev):
    """The accelerometer, gyroscope and integration covariances [3, 3, 3]
    of phase 14's launches, float64."""
    return torch.tensor(np.stack([0.01 * np.eye(3), 1e-4 * np.eye(3),
                                  1e-8 * np.eye(3)]), device=dev)


def _preint_launcher(kind, inputs, covs, plain=False):
    """fn() calling one of the three scans, kernel or plain version, on
    `inputs`, its arguments made ready once."""
    accs, gyros, dts, bias = inputs
    if kind == "tangent":
        fn = preint_ops.preint_tangent_ref if plain else \
            preint_ops.preint_tangent
        return lambda: fn(accs, gyros, dts, bias, covs)
    fn = preint_ops.preint_rotation_ref if plain else \
        preint_ops.preint_rotation
    if kind == "manifold":
        return lambda: fn("manifold", gyros, dts, bias, accs=accs)
    bias_w, gyro_cov = bias[:, 3:].contiguous(), covs[1].contiguous()
    return lambda: fn("ahrs", gyros, dts, bias_w, gyro_cov=gyro_cov)


def _preint_call(kind, inputs, covs, plain=False):
    """One of the three scans, kernel or plain version, on `inputs`."""
    return _preint_launcher(kind, inputs, covs, plain)()


def preint_bound(kind, S, N, itemsize):
    """(bound_ms, bound_by, what) of one launch: the largest of the samples
    read once (7 values each, 4 in AHRS mode) and the outputs written once
    over the HBM rate, the operations over the float64 rate, and the
    dependent chain, a model: preint_tangent's N steps of
    TANGENT_STEP_CYCLES; preint_rotation's ("manifold", "ahrs") one element
    and ceil(log2 N) combines deep. The chain's steps are operations, so it
    is `bound_by` "operations" too; `what` names the term that bounds."""
    reads = 4 if kind == "ahrs" else 7
    out = {"tangent": 145, "manifold": 15 + 6 * 15,
           "ahrs": 9 + 3 * 9 + 9}[kind]
    by_bytes = (reads * S * N + out * S) * itemsize / HBM_BYTES_PER_S * 1e3
    flops = {"tangent": TANGENT_FLOPS, "manifold": ROTATION_FLOPS,
             "ahrs": AHRS_FLOPS}[kind]
    by_ops = flops * S * N / FP64_FLOP_PER_S * 1e3
    if kind == "tangent":
        cycles, chain = N * TANGENT_STEP_CYCLES, "dependent chain"
    else:
        cycles = ELEMENT_CYCLES + math.ceil(math.log2(max(N, 1))) * \
            COMBINE_CYCLES
        chain = "reduction depth"
    by_chain = cycles / CLOCK_HZ * 1e3
    terms = {"bytes": by_bytes, "operations": by_ops, chain: by_chain}
    what = max(terms, key=terms.get)
    return terms[what], ("bytes" if what == "bytes" else "operations"), (
        f"bytes {by_bytes * 1e3:.2f} us, operations {by_ops * 1e3:.2f} us, "
        f"{chain} {by_chain * 1e3:.2f} us: {what}")


def phase_preint(dev):
    """The preintegration kernels against their plain versions on the card;
    returns the records of preint_tangent and preint_rotation (float64, the
    batch path's launch of 2000 segments of 200 samples) and
    preint_rotation's launches through the public entry points."""
    covs64 = _preint_covs(dev)
    cases = ((f"S={PREINT_S} x N={PREINT_N}", [PREINT_N] * PREINT_S, 0),
             (f"ragged 1/37/{PREINT_N}", [1, 37, PREINT_N], 1))
    for label, lengths, seed in cases:
        in64 = _preint_inputs(lengths, torch.float64, dev, seed)
        in32 = tuple(x.float() for x in in64)
        for kind in ("tangent", "manifold", "ahrs"):
            k64 = _preint_call(kind, in64, covs64)
            p64 = _preint_call(kind, in64, covs64, plain=True)
            k32 = _preint_call(kind, in32, covs64.float())
            p32 = _preint_call(kind, in32, covs64.float(), plain=True)
            torch.cuda.synchronize()
            worst = []
            for o, (a, b, c, d) in enumerate(zip(k64, p64, k32, p32)):
                scale = b.abs().max().item()
                e64 = (a - b).abs().max().item()
                e32 = (c.double() - b).abs().max().item()
                own = (d.double() - b).abs().max().item()
                lim32 = max(4 * own, 1e-4 * scale)
                if not (e64 <= 1e-10 * scale and e32 <= lim32):
                    raise RuntimeError(
                        f"[14] {kind} {label} output {o}: kernel float64 "
                        f"{e64:.3e} (limit {1e-10 * scale:.3e}), float32 "
                        f"{e32:.3e} (limit {lim32:.3e})")
                worst.append((e64 / max(scale, 1e-300), e32 / lim32))
            print(f"[14] {kind:8s} {label}: kernel == plain on the card, "
                  f"float64 worst {max(w[0] for w in worst):.2e} of the "
                  f"largest entry (limit 1e-10); float32 worst "
                  f"{max(w[1] for w in worst):.2f} of its limit (4 x the "
                  f"plain float32's own distance, floor 1e-4)")

    # one long segment, float64: the rotation kernel's carry across rounds
    long = _preint_inputs([PREINT_LONG], torch.float64, dev, 3)
    for kind in ("manifold", "ahrs"):
        t0 = time.perf_counter()
        got = _preint_call(kind, long, covs64)
        ref = _preint_call(kind, long, covs64, plain=True)
        torch.cuda.synchronize()
        worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
                    .item() for a, b in zip(got, ref))
        print(f"[14] {kind:8s} float64 1 x {PREINT_LONG}: kernel == plain on "
              f"the card, worst {worst:.2e} of the largest entry (limit "
              f"1e-10); {time.perf_counter() - t0:.1f} s with the plain "
              f"version")
        if not worst <= 1e-10:
            raise RuntimeError(f"[14] {kind} 1 x {PREINT_LONG}: {worst:.3e}")

    # the rotation kernel's order does not depend on N: the 37-sample
    # segment of the ragged batch, padded to 200, equals itself alone
    ragged = _preint_inputs([1, 37, PREINT_N], torch.float64, dev, 1)
    for dtype in (torch.float64, torch.float32):
        padded = tuple(x.to(dtype) for x in ragged)
        alone = tuple(x[1:2, :37].contiguous() for x in padded)
        for kind in ("manifold", "ahrs"):
            a = _preint_call(kind, padded, covs64.to(dtype))
            b = _preint_call(kind, alone, covs64.to(dtype))
            if not all(torch.equal(x[1], y[0]) for x, y in zip(a, b)):
                raise RuntimeError(f"[14] preint_rotation {kind} {dtype}: "
                                   f"the padded segment differs from itself "
                                   f"alone")
    print(f"[14] preint_rotation: a segment of 37 samples padded to "
          f"{PREINT_N} equals itself alone bit for bit (manifold, AHRS; "
          f"float64, float32)")

    # the manifold backend and AHRS through their entry points, counted
    in64 = _preint_inputs([PREINT_N] * PREINT_S, torch.float64, dev, 0)
    accs, gyros, dts, bias = in64
    params = pre.PreintegrationParams.make_shared_u(device=dev)
    preint_ops.preint_rotation.launches = 0
    preint_ops.preint_tangent.launches = 0
    pm = pre.integrate_manifold_batch(params, bias, accs, gyros, dts)
    pa = pre.integrate_ahrs_batch(params.gyro_cov, bias[:, 3:], gyros, dts)
    torch.cuda.synchronize()
    rot_launches = preint_ops.preint_rotation.launches
    print(f"[14] integrate_manifold_batch and integrate_ahrs_batch of "
          f"{PREINT_S} segments: preint_rotation.launches = {rot_launches}, "
          f"preint_tangent.launches = {preint_ops.preint_tangent.launches}; "
          f"finite: {bool(torch.isfinite(pm.H_ba).all())}, "
          f"{bool(torch.isfinite(pa.H_bw).all())}")
    if rot_launches != 2 or not (torch.isfinite(pm.zeta).all()
                                 and torch.isfinite(pa.theta).all()):
        raise RuntimeError("[14] the manifold and AHRS entry points did not "
                           "go through preint_rotation")

    # times of the batch path's launch and of the stream's (one segment):
    # `ms` by CUDA events around launches from the host, as in earlier
    # phases and PRs; `device_ms` beside it, the device's time per launch
    # from a CUDA graph of launches (a kernel of microseconds is faster
    # than the wrapper's host path, and the profiler, after earlier passes
    # in this process, can record no event of a kernel launched through
    # ctypes)
    one = _preint_inputs([PREINT_N], torch.float64, dev, 2)
    rows = {}
    for kind in ("tangent", "manifold", "ahrs"):
        for S, inputs in ((PREINT_S, in64), (1, one)):
            kernel = _preint_launcher(kind, inputs, covs64)
            ms = _time_ms(kernel, 10 if S > 1 else 20)
            device_ms = _graph_ms(kernel, 20)
            if not (ms > 0 and device_ms > 0):
                raise RuntimeError(f"[14] {kind}: {ms}, {device_ms} ms per "
                                   f"launch")
            got = kernel()
            _sync(dev)
            t0 = time.perf_counter()
            ref = _preint_call(kind, inputs, covs64, plain=True)
            _sync(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            bound_ms, bound_by, what = preint_bound(kind, S, PREINT_N, 8)
            step = (f"{1e3 * ms / PREINT_N:.2f} us per dependent step; "
                    if kind == "tangent" else "")
            print(f"[14] {kind} float64 {S} x {PREINT_N}: kernel {ms:.4f} "
                  f"ms per launch (CUDA events), device {device_ms:.4f} ms "
                  f"(a CUDA graph of 20), {step}plain version "
                  f"{plain_ms:.1f} ms (host clock, one call); bound "
                  f"{bound_ms * 1e3:.2f} us ({what}), {100 * bound_ms / ms:.2f}"
                  f"% of the kernel's time, {100 * bound_ms / device_ms:.2f}% "
                  f"of the device's; max |kernel - plain| {err:.2e}")
            rows[kind, S] = {"max_abs_err": err, "ms": ms,
                             "device_ms": device_ms,
                             "plain_ms": plain_ms, "bound_ms": bound_ms,
                             "bound_by": bound_by, "bound_model": what,
                             "library_ms": None}
    # the entry points whole: the kernels, so3.logmap and its jvp (and in
    # the manifold backend preint_tangent for the covariance), by CUDA
    # events around 10 calls, which take the host's time in as well
    entry = {}
    for S, (accs, gyros, dts, bias) in ((PREINT_S, in64), (1, one)):
        entry[S] = (
            _time_ms(lambda: pre.integrate_manifold_batch(
                params, bias, accs, gyros, dts), 10),
            _time_ms(lambda: pre.integrate_ahrs_batch(
                params.gyro_cov, bias[:, 3:], gyros, dts), 10))
        print(f"[14] entry points, float64 {S} x {PREINT_N}: "
              f"integrate_manifold_batch {entry[S][0]:.4f} ms a call "
              f"(preint_rotation {rows['manifold', S]['ms']:.4f} and "
              f"preint_tangent {rows['tangent', S]['ms']:.4f} of it), "
              f"integrate_ahrs_batch {entry[S][1]:.4f} ms (preint_rotation "
              f"{rows['ahrs', S]['ms']:.4f})")
    # each record is the launch of its kernel's main path: preint_tangent's
    # the stream's one segment (phase 17), preint_rotation's the batch of
    # phase 14's entry points; the other launches stand beside it
    tangent = dict(rows["tangent", 1],
                   batch_launch={"S": PREINT_S, **rows["tangent", PREINT_S]})
    rotation = dict(
        rows["manifold", PREINT_S],
        one_segment={"S": 1, **rows["manifold", 1]},
        ahrs={"S": PREINT_S, **rows["ahrs", PREINT_S]},
        ahrs_one_segment={"S": 1, **rows["ahrs", 1]},
        entry_points_ms={f"S={S}": {"integrate_manifold_batch": m,
                                    "integrate_ahrs_batch": a}
                         for S, (m, a) in entry.items()})
    return tangent, rotation, rot_launches


def _vio_data(path, n_fixes, seed):
    truth = write_imu_gps_csv(path, n_fixes, seed)
    init, segs, gps = vio.load_imu_gps_csv(path)
    pose0, vel0 = vio.initial_state(init)
    return pose0, vel0, segs, gps, truth


def _quiet(*_):
    pass


def phase_vio_parity(dev, tmp):
    """The IMU + GPS paths at 20 fixes in float64, card against CPU."""
    pose0, vel0, segs, gps, _ = _vio_data(f"{tmp}/vio_small.csv", VIO_SMALL,
                                          11)
    out = {}
    for d in (dev, torch.device("cpu")):
        rec = vio.run_batch(pose0, vel0, segs, gps, VIO_SMALL, device=d,
                            dtype=torch.float64, say=_quiet)
        isam, recs = vio.run_stream(pose0, vel0, segs, gps, VIO_SMALL,
                                    device=d,
                                    dtype=torch.float64, say=_quiet)
        ups = [r for _, us in recs[:-1] for _, r in us] + recs[-1]
        out[d.type] = (rec["result"], ups,
                       {g: isam.estimate_array(g)
                        for g in ("se3", "vel3", "imu_bias")}, isam.error())
    (bc, uc, ec, errc), (bh, uh, eh, errh) = out["cuda"], out["cpu"]
    rel = abs(bc.error - bh.error) / bh.error
    rows_c = [u.relinearized_rows for u in uc]
    rows_h = [u.relinearized_rows for u in uh]
    gap = max(np.abs(ec[g] - eh[g]).max() for g in ec)
    cg_gap = max(abs(a.cg_iterations - b.cg_iterations)
                 for a, b in zip(uc, uh))
    print(f"[15] {VIO_SMALL} fixes, float64: batch LM error "
          f"{bc.error:.10g} on the card, {bh.error:.10g} on the CPU (rel "
          f"{rel:.2e}, limit 1e-9), {bc.iterations} and {bh.iterations} "
          f"iterations")
    print(f"[15] ISAM2 stream, {len(uc)} updates: relinearized rows equal: "
          f"{rows_c == rows_h}; estimates max |card - CPU| {gap:.2e} (limit "
          f"1e-8); CG iterations within {cg_gap}; error {errc:.10g} / "
          f"{errh:.10g}")
    if not rel <= 1e-9:
        raise RuntimeError(f"[15] batch error card {bc.error} CPU {bh.error}")
    if rows_c != rows_h or not gap <= 1e-8:
        raise RuntimeError(f"[15] the stream left the CPU's: rows "
                           f"{rows_c} vs {rows_h}, estimates {gap}")


def phase_vio_batch(dev, tmp):
    """The batch path at 2000 fixes (400 000 samples) in float64, LM from
    the GPS-aided start under the gates; the JAX example's dead-reckoned
    start is printed, not run: over 33 minutes it drifts by the double
    integral of the accelerometer bias's random walk."""
    t0 = time.perf_counter()
    path = f"{tmp}/vio_{VIO_BATCH_FIXES}.csv"
    truth = write_imu_gps_csv(path, VIO_BATCH_FIXES, 12)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    init, segs, gps = vio.load_imu_gps_csv(path)
    t_parse = time.perf_counter() - t0
    pose0, vel0 = vio.initial_state(init)
    params = vio.imu_params(device=dev)
    poses, _ = vio.dead_reckon(vio.integrate_segments(
        params, segs, np.zeros(6), device=dev, dtype=torch.float64), params,
        pose0, vel0)
    drift = vio.position_errors(poses[1:, :, 3].cpu().numpy(), gps,
                                VIO_BATCH_FIXES, truth)
    print(f"[16] the dead-reckoned start (the JAX example's): position "
          f"error against the truth mean {drift.mean():.1f} m, max "
          f"{drift.max():.1f} m")
    preint_ops.preint_tangent.launches = 0
    rec = vio.run_batch(pose0, vel0, segs, gps, VIO_BATCH_FIXES, device=dev,
                        dtype=torch.float64, solver="schur", max_part=128,
                        start="gps", say=lambda s: print(f"[16] {s}"))
    launches = preint_ops.preint_tangent.launches
    res = rec["result"]
    err = vio.position_errors(res.values["se3"][1:, :, 3].cpu().numpy(), gps,
                              VIO_BATCH_FIXES, truth)
    sec = rec["seconds"]
    print(f"[16] {VIO_BATCH_FIXES} fixes, {sum(len(s) for s in segs)} "
          f"samples, GPS-aided start: seconds per step: write {t_write:.2f}, "
          f"CSV parse {t_parse:.2f}, preintegration {sec['preintegrate']:.4f} "
          f"({launches} preint_tangent launch), initialization "
          f"{sec['init']:.3f}, graph {sec['build']:.2f}, plan "
          f"{sec['plan']:.2f}, LM {sec['lm']:.2f}; error "
          f"{rec['initial']:.6g} -> {res.error:.10g} in {res.iterations} "
          f"iterations (converged {res.converged}); position error against "
          f"the truth mean {err.mean():.4f} m, max {err.max():.4f} m")
    if not (np.isfinite(res.error) and res.error < rec["initial"]):
        raise RuntimeError(f"gate: [16] error {rec['initial']} -> "
                           f"{res.error}")
    if not err.mean() < 1.0:
        raise RuntimeError(f"gate: [16] mean position error {err.mean()}")
    if launches != 1:
        raise RuntimeError(f"[16] {launches} preint_tangent launches, not 1")


def phase_vio_stream(dev, tmp):
    """The stream at VIO_STREAM_FIXES fixes with the example's settings and
    the preconditioner rebuilt every update, under its gates; returns
    preint_tangent's launches in the stream."""
    pose0, vel0, segs, gps, truth = _vio_data(f"{tmp}/vio_stream.csv",
                                              VIO_STREAM_FIXES, 13)
    n = VIO_STREAM_FIXES
    batch = vio.run_batch(pose0, vel0, segs, gps, n, device=dev,
                          dtype=torch.float64, solver="schur", start="gps",
                          say=_quiet)
    optimum = batch["result"].error
    preint_ops.preint_tangent.launches = 0
    chain_factorize.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    isam, recs = vio.run_stream(pose0, vel0, segs, gps, n,
                                refresh=VIO_STREAM_REFRESH, device=dev,
                                dtype=torch.float64, say=_quiet)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = preint_ops.preint_tangent.launches
    chain_launches = chain_factorize.launches
    fix_s = [s for s, _ in recs[:-1]]
    ups = [u for _, us in recs[:-1] for u in us]
    err = isam.error()
    pos = vio.position_errors(isam.estimate_array("se3")[1:, :, 3], gps, n,
                              truth)
    cap = isam._cap_n["se3"]
    d = sum(manifolds.get(g).dim
            for g in vio.SUPERCHAIN.split(":")[1].split("+"))
    print(f"[17] {n} fixes, {sum(len(s) for s in segs[:n])} samples, "
          f"float64, {vio.SUPERCHAIN}, "
          f"CG 500 at 1e-10, 3 updates a fix, preconditioner rebuilt every "
          f"{VIO_STREAM_REFRESH} update(s): {wall:.1f} s, "
          f"{1e3 * np.mean(fix_s):.2f} ms per fix (median "
          f"{1e3 * np.median(fix_s):.2f}), "
          f"{1e3 * np.mean([s for s, _ in ups]):.2f}"
          f" ms per update, CG iterations per update mean "
          f"{np.mean([r.cg_iterations for _, r in ups]):.1f} max "
          f"{max(r.cg_iterations for _, r in ups)}, relinearized rows "
          f"mean {np.mean([r.relinearized_rows for _, r in ups]):.1f}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print(f"[17] final error {err:.10g}, float64 batch optimum of the same "
          f"graph {optimum:.10g} (ratio {err / optimum:.6f}); position error "
          f"against the truth mean {pos.mean():.4f} m, max {pos.max():.4f} "
          f"m; preint_tangent.launches = {launches} ({n} fixes); "
          f"chain_factorize.launches = {chain_launches} at d = {d}, "
          f"capacity {cap}")
    if not (np.isfinite(err) and err <= 1.05 * optimum):
        raise RuntimeError(f"gate: [17] error {err} above 1.05 x {optimum}")
    if not pos.mean() < 1.0:
        raise RuntimeError(f"gate: [17] mean position error {pos.mean()}")
    if launches != n:
        raise RuntimeError(f"gate: [17] preint_tangent launched {launches} "
                           f"times for {n} fixes")
    if not (chain_launches > 0 and d == 15):
        raise RuntimeError(f"gate: [17] chain_factorize launched "
                           f"{chain_launches} times at d = {d}")
    return launches, cap, d


def chain_time_stream(dev, cap, d):
    """chain_factorize's time at phase 17's capacity and block size, taken
    once phase 18's second process has ended."""
    Dm, Om = chain.chain_prepare(*_spd_chain(d, cap, dev, 17), cap, CHAIN_LAM)
    c_ms = _time_ms(lambda: chain_factorize(Dm, Om), 20)
    bound_ms, _, what = chain_bound(cap, d, 8)
    print(f"[17] chain_factorize float64 cap {cap} d={d}: {c_ms:.4f} ms per "
          f"call (CUDA events, 20 calls), {1e6 * c_ms / cap:.0f} ns per "
          f"block; bound {bound_ms * 1e3:.2f} us ({what}), "
          f"{100 * bound_ms / c_ms:.2f}% of the kernel's time")


def smart_stream_child(out_path):
    """Phase 18's full-size stream in a second process: tools/
    isam2_smart_factor.py's run() on the card, its record to OUT as JSON.
    One CPU thread: the stream's host work is one Python thread, and the
    parity process runs beside it."""
    torch.set_num_threads(1)
    dev = config.device("cuda")
    lines = []
    big = smart_tool.run(SMART_POSES, SMART_LANDMARKS,
                         refine_iters=SMART_REFINE_ITERS, device=dev,
                         say=lines.append)
    truth = smart_tool.make_scene(SMART_POSES, SMART_LANDMARKS, 4,
                                  0.002)[0][:, :, 3]
    res = big["batch"]
    rec = {"lines": lines, "error": big["isam"].error(),
           "batch": res.error, "batch_iterations": res.iterations,
           "n_smart": big["n_smart"], "pos_err": big["pos_err"],
           "dpos": big["dpos"], "update_ms": [1e3 * t
                                              for t in big["update_s"]],
           "ate": metrics.ate(big["isam"].estimate_array("se3")[:, :, 3],
                              truth)["rmse"],
           "batch_ate": metrics.ate(
               res.values["se3"][:, :, 3].cpu().numpy(), truth)["rmse"]}
    with open(out_path, "w") as f:
        json.dump(rec, f)


def parity_child(tmp):
    """Phases 9 and 15, card against CPU, in a third process: they time
    nothing. Four CPU threads for their CPU sides, the rest of the host
    for the other two processes."""
    torch.set_num_threads(4)
    dev = config.device("cuda")
    data, stream_end = phase_isam_parity(dev)
    phase_checkpoint(dev, data, stream_end, tmp)
    phase_vio_parity(dev, tmp)


CHILDREN = {"smart": "phase 18's full-size stream",
            "parity": "phases 9 and 15",
            "breadth": "phase 19's card == CPU checks and phases 20, 22 "
                       "and 25",
            "comparer": "phase 22's tools/solver_comparer.py run",
            "hybrid": "phase 24's hybrid City10000 stream",
            "dist": "phase 26's distributed paths",
            "tools": "phase 27's seven tools"}


def start_child(kind, tmp):
    """Start `chip_smoke.py --child KIND TMP` (smart_stream_child or
    parity_child) in a process group of its own, so that the processes it
    starts (phase 26's ranks) can be stopped with it; returns (kind,
    process, log path)."""
    log = f"{tmp}/{kind}.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", kind, tmp],
            stdout=f, stderr=subprocess.STDOUT, start_new_session=True)
    print(f"[children] {CHILDREN[kind]} started in process {proc.pid}")
    return kind, proc, log


def join_child(child):
    """Wait for a child; print its log (the parity phases' lines) or, if
    it failed, the end of it; raise if it failed."""
    kind, proc, log = child
    t0 = time.perf_counter()
    rc = proc.wait(timeout=CHILD_TIMEOUT)
    print(f"[children] waited {time.perf_counter() - t0:.1f} s for "
          f"{CHILDREN[kind]} (exit code {rc})")
    with open(log) as f:
        text = f.read()
    if kind != "smart" or rc != 0:
        print(text if rc == 0 else text[-4000:], end="")
    if rc != 0:
        raise RuntimeError(f"the process of {CHILDREN[kind]} exited with "
                           f"{rc}")


def phase_smart(dev, child, tmp):
    """Smart factors streamed into ISAM2: the example's scene card against
    CPU (CG to convergence), then the full-size stream's record from its
    process `child` (start_child("smart", tmp)) under its gates."""
    out = {}
    for d in (dev, torch.device("cpu")):
        out[d.type] = smart_tool.run(device=d, cg_maxiter=300, cg_tol=1e-10,
                                     say=_quiet)
    c, h = out["cuda"], out["cpu"]
    gap = np.abs(c["isam"].estimate_array("se3")
                 - h["isam"].estimate_array("se3")).max()
    print(f"[18] 12 poses, 30 landmarks, T = 4, float64, CG to 1e-10: "
          f"estimates max |card - CPU| {gap:.2e} (limit 1e-8); errors "
          f"{c['isam'].error():.10g} / {h['isam'].error():.10g}; batch "
          f"{c['batch'].error:.10g} / {h['batch'].error:.10g}")
    if not gap <= 1e-8:
        raise RuntimeError(f"[18] smart stream card vs CPU {gap}")
    join_child(child)
    path = f"{tmp}/smart_stream.json"
    with open(path) as f:
        big = json.load(f)
    for line in big["lines"]:
        print(f"[18] {line}")
    err, opt, ms = big["error"], big["batch"], np.array(big["update_ms"])
    print(f"[18] {SMART_POSES} poses, {big['n_smart']} smart factors, "
          f"{SMART_REFINE_ITERS} Gauss-Newton steps a triangulation, the "
          f"example's engine defaults: {ms.mean():.2f} ms per update "
          f"(median {np.median(ms):.2f}, {len(ms)} updates, beside phases "
          f"9 and 15-17); error {err:.8g} vs batch {opt:.8g} "
          f"({big['batch_iterations']} LM iterations; ratio {err / opt:.5f}, "
          f"limit 1.05); aligned ATE "
          f"rmse {big['ate']:.4f} m (limit {SMART_ATE_BOUND}; the batch "
          f"optimum's {big['batch_ate']:.4f} m); mean position error "
          f"{big['pos_err']:.4f} m unaligned")
    if not (np.isfinite(err) and err <= 1.05 * opt):
        raise RuntimeError(f"gate: [18] error {err} above 1.05 x {opt}")
    if not big["ate"] < SMART_ATE_BOUND:
        raise RuntimeError(f"gate: [18] aligned ATE rmse {big['ate']}")


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


SHONAN_PMAX = 7
SHONAN_RMS_FACTOR = 1.1     # the result's rms error / the chordal start's
SHONAN_PREFIX = 100         # poses of the card == CPU staircase
POWER_STEPS = 400           # min_eigenvalue's steps (its default)


def rotation_errors(Rs, truth):
    """(largest, rms) angle in rad between rotations [n, 3, 3] and the
    truth's [n, 3, 4], both taken to the gauge R_0 = I."""
    A = np.einsum("ba,nbc->nac", Rs[0], Rs)
    B = np.einsum("ba,nbc->nac", truth[0, :, :3], truth[:, :, :3])
    ang = np.arccos(np.clip((np.einsum("nab,nab->n", A, B) - 1) / 2, -1, 1))
    return float(ang.max()), float(np.sqrt((ang ** 2).mean()))


def sphere_rotations():
    """(edges [K, 2], relative rotations [K, 3, 3], truth) of the sphere
    stand-in, as the file carries them."""
    truth, edges, meas, _ = sphere_standin()
    return np.asarray(edges), meas[:, :, :3], truth


def _profiled(fn):
    """(fn(), wall ms, device ms, device events) of one profiled call."""
    _sync("cuda")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        _sync("cuda")
        wall = (time.perf_counter() - t0) * 1e3
    total, events, _ = device_ms(prof)
    return out, wall, total, events


def phase_shonan(dev, tmp):
    """Shonan averaging at full size: tools/shonan_averaging_cli.py's run
    on the 2500-pose sphere stand-in, p = 3..SHONAN_PMAX, float64, from the
    opt-in chordal start (sfm/shonan.py:chordal_start); seconds by level,
    PCG iterations, the power method's ms a step, errors against the truth;
    then one profiled PCG solve, LM iteration and power method at p = 3,
    and translation_recovery at the sphere's size."""
    path = f"{tmp}/sphere_standin.g2o"
    truth = write_sphere(path)
    torch.cuda.reset_peak_memory_stats()
    notes = []
    rec = shonan_cli.run(path, 3, SHONAN_PMAX, device=dev, start="chordal",
                         say=lambda s: print(f"[19] {s}"),
                         note=notes.append)
    peak = _peak_mib(dev)
    res = rec["result"]
    print(f"[19] chordal start (host, opt-in, ROADMAP queue 3 C11): "
          f"{rec['chordal_s']:.3f} s")
    for lv in rec["levels"]:
        pcg = np.array(lv["pcg"])
        print(f"[19] p={lv['p']}: LM {lv['lm_s']:.3f} s, "
              f"{lv['lm_iterations']} iterations, {len(pcg)} tries, PCG "
              f"{pcg.mean():.1f} iterations a try (largest {pcg.max()}, "
              f"{int((pcg >= 400).sum())} at the cap of 400); "
              f"min_eigenvalue {lv['eig_s']:.3f} s, "
              f"{lv['eig_s'] * 1e3 / POWER_STEPS:.3f} ms a power step, "
              f"min_eig {lv['min_eig']:.4e}")
    e_res = rotation_errors(res.rotations, truth)
    e_ch = rotation_errors(rec["chordal"], truth)
    print(f"[19] staircase {rec['seconds']:.3f} s (chordal start included):"
          f" certified {res.certified} at p={res.p_final}, min_eig "
          f"{res.min_eig:.4e}, cost {res.cost:.9g}; angular error against "
          f"the truth (R_0 = I): result largest {e_res[0]:.5f} rad, rms "
          f"{e_res[1]:.6f}; chordal start alone largest {e_ch[0]:.5f}, rms "
          f"{e_ch[1]:.6f}; peak memory {peak:.0f} MiB")
    if not res.certified:
        raise RuntimeError(f"gate: [19] not certified up to p = "
                           f"{SHONAN_PMAX} (min_eig {res.min_eig})")
    if not e_res[1] <= SHONAN_RMS_FACTOR * e_ch[1]:
        raise RuntimeError(f"gate: [19] rms error {e_res[1]} above "
                           f"{SHONAN_RMS_FACTOR} x the chordal start's "
                           f"{e_ch[1]}")
    print(f"[19] gates passed: certified; rms {e_res[1]:.6f} <= "
          f"{SHONAN_RMS_FACTOR} x {e_ch[1]:.6f}")

    # one PCG solve, one LM iteration and the power method at p = 3, from
    # the chordal start, each under the profiler
    edges, R_meas = rec["edges"], rec["R_meas"]
    kappa = np.ones(len(edges))
    graph = shonan.build_graph_at(3, edges, R_meas, kappa, device=dev,
                                  dtype=torch.float64)
    values = Values({"sop3": torch.tensor(rec["chordal"], device=dev)})
    lin = linearize(graph, values)
    with shonan_cli.count_pcg_iterations() as used:
        _, wall, dev_ms, events = _profiled(lambda: solvers.solve_pcg(
            lin, 1e-5, maxiter=400, tol=1e-8))
    it = used[0]
    print(f"[19] one PCG solve at p=3 (lambda 1e-5, the chordal start): "
          f"{it} iterations, {wall:.1f} ms wall with the profiler on, "
          f"device {dev_ms:.2f} ms; {events / it:.1f} device events and "
          f"{wall / it:.3f} ms wall a PCG iteration (the preconditioner's "
          f"factorization and the right side included)")
    params = optimizers.Params(solver="pcg", pcg_maxiter=400,
                               max_iterations=1)
    _, wall, dev_ms, events = _profiled(lambda: optimizers.optimize_lm(
        graph, values, params))
    print(f"[19] one LM iteration at p=3: wall {wall:.1f} ms (profiler "
          f"on), device {dev_ms:.2f} ms, busy share {dev_ms / wall:.3f}, "
          f"{events} device events")
    Y3 = rec["chordal"]
    (_, _), wall, dev_ms, events = _profiled(lambda: shonan.min_eigenvalue(
        edges, R_meas, kappa, Y3, iters=50, device=dev))
    print(f"[19] min_eigenvalue, 50 steps: wall {wall:.1f} ms (profiler "
          f"on), device {dev_ms:.2f} ms, {events / 52:.1f} device events a "
          f"step (50 steps and two Rayleigh quotients)")

    # translation averaging at the sphere's size, directions from the truth
    t = truth[:, :, 3]
    d = t[edges[:, 1]] - t[edges[:, 0]]
    dirs = d / np.linalg.norm(d, axis=1, keepdims=True)
    est, secs = _timed(lambda: averaging.translation_recovery(
        edges, dirs, scale=float(np.linalg.norm(d[0])), device=dev), dev)
    ate = metrics.ate(est, t - t[0], align=True, with_scale=True)["rmse"]
    print(f"[19] translation_recovery, {len(t)} positions from {len(edges)} "
          f"exact directions (dense LM, the default): {secs:.2f} s, "
          f"similarity-aligned ATE rmse {ate:.3e} m")
    queue2_item7(dev)


def queue2_item7(dev):
    """The two short loops ROADMAP queue 2 item 7 keeps as torch ops, timed
    on the card: karcher_mean_so3 (20 steps) of 2500 rotations, and one
    IncrementalSmoother.solve() (3 damped Gauss-Newton steps, PCG at most
    60) at the end of a 300-pose Manhattan stream."""
    rng = np.random.default_rng(3)
    Rs = so3.expmap(torch.tensor(0.05 * rng.normal(size=(2500, 3)),
                                 device=dev)) @ so3.expmap(torch.tensor(
                                     [0.4, -0.1, 0.2], dtype=torch.float64,
                                     device=dev))
    averaging.karcher_mean_so3(Rs)
    ms = [1e3 * _timed(lambda: averaging.karcher_mean_so3(Rs), dev)[1]
          for _ in range(3)]
    _, wall, dev_ms, events = _profiled(lambda: averaging.karcher_mean_so3(
        Rs))
    print(f"[19] karcher_mean_so3, 2500 rotations, 20 steps: "
          f"{', '.join(f'{m:.2f}' for m in ms)} ms a call; profiled "
          f"{wall:.2f} ms wall, device {dev_ms:.3f} ms, {events / 20:.1f} "
          f"device events a step")
    inc = _manhattan_stream(dev, 300)
    inc.solve()
    ms = [1e3 * _timed(inc.solve, dev)[1] for _ in range(3)]
    _, wall, dev_ms, events = _profiled(inc.solve)
    print(f"[19] IncrementalSmoother.solve() at {inc.n} poses, {inc.f} "
          f"factors (capacities {inc.cap_n} / {inc.cap_f}): "
          f"{', '.join(f'{m:.1f}' for m in ms)} ms a call; profiled "
          f"{wall:.1f} ms wall, device {dev_ms:.2f} ms, busy share "
          f"{dev_ms / wall:.3f}, {events} device events")


def _seconds_since(t0):
    return time.perf_counter() - t0


def phase_shonan_parity(dev, tmp):
    """Phase 19's card == CPU checks, in the breadth child: the staircase on
    the sphere's first SHONAN_PREFIX poses (same start, same v0),
    translation_recovery on a small seeded problem, and the JAX example's
    own start on the full sphere as a record (not a gate: it changes from
    run to run, ROADMAP queue 3 C11)."""
    edges, R_meas, truth = sphere_rotations()
    keep = edges.max(1) < SHONAN_PREFIX
    e, R = edges[keep], R_meas[keep]
    init = shonan.chordal_start(e, R, SHONAN_PREFIX)
    v0 = np.random.default_rng(1).normal(size=(SHONAN_PREFIX, 3))
    c, h = (shonan.shonan_averaging(e, R, init=init, v0=v0, device=d)
            for d in (dev, torch.device("cpu")))
    gap = np.abs(c.rotations - h.rotations).max()
    print(f"[19] {SHONAN_PREFIX}-pose prefix ({len(e)} edges), card / CPU: "
          f"certified {c.certified} / {h.certified} at p={c.p_final} / "
          f"{h.p_final}, min_eig {c.min_eig:.6e} / {h.min_eig:.6e}; "
          f"rotations max |card - CPU| {gap:.2e} (limit 1e-8)")
    if ((c.certified, c.p_final) != (h.certified, h.p_final)
            or not gap <= 1e-8 or not abs(c.min_eig - h.min_eig) <= 1e-6):
        raise RuntimeError("[19] the staircase on the card left the CPU's")
    rng = np.random.default_rng(2)
    tt = rng.normal(scale=2.0, size=(6, 3))
    ij = np.array([(i, j) for i in range(6) for j in range(i + 1, 6)])
    dd = tt[ij[:, 1]] - tt[ij[:, 0]]
    dirs = dd / np.linalg.norm(dd, axis=1, keepdims=True)
    a, b = (averaging.translation_recovery(ij, dirs, scale=1.0, device=d)
            for d in (dev, "cpu"))
    print(f"[19] translation_recovery, 6 positions: max |card - CPU| "
          f"{np.abs(a - b).max():.2e} (limit 1e-9)")
    if not np.abs(a - b).max() <= 1e-9:
        raise RuntimeError("[19] translation_recovery card vs CPU")
    path = f"{tmp}/sphere_reference_start.g2o"
    write_sphere(path)
    t0 = time.perf_counter()
    rec = shonan_cli.run(path, 3, SHONAN_PMAX, device=dev,
                         start="reference", say=_quiet, note=_quiet)
    r = rec["result"]
    print(f"[19] the JAX example's start on the sphere (a record): "
          f"{_seconds_since(t0):.1f} s, certified {r.certified} at p="
          f"{r.p_final}, {len(rec['levels'])} levels; rms error of the "
          f"result {rotation_errors(r.rotations, truth)[1]:.4f} rad, of "
          f"that start {rotation_errors(rec['chordal'], truth)[1]:.4f} rad "
          f"(its transpose "
          f"{rotation_errors(np.swapaxes(rec['chordal'], 1, 2), truth)[1]:.4f})")


def _chain_problem(dev):
    gb = GraphBuilder()
    F.add_prior(gb, "se2", 0, np.zeros(3), F.diag_noise([0.1] * 3))
    for i in range(3):
        F.add_between(gb, "se2", i, i + 1, np.array([1.0, 0, 0]),
                      F.diag_noise([0.1] * 3))
    poses = np.zeros((4, 3))
    poses[:, 0] = np.arange(4)
    return gb.build(device=dev, dtype=torch.float64), values_from_numpy(
        {"se2": poses}, device=dev, dtype=torch.float64)


def _gnc_problem(dev):
    """tests/test_shonan_gnc.py's GNC graph: 12 poses, a closure and two
    outlier closures in the last batch."""
    rng = np.random.default_rng(4)
    n = 12
    truth = [np.zeros(3)]
    for _ in range(n - 1):
        truth.append(se2.compose(torch.tensor(truth[-1]), torch.tensor(
            [1.0, 0.0, 0.3])).numpy())
    truth = np.stack(truth)
    gb = GraphBuilder()
    F.add_prior(gb, "se2", 0, truth[0], F.diag_noise([0.1, 0.1, 0.05]))
    pri = gb.build(device=dev, dtype=torch.float64)
    gb = GraphBuilder()
    noise = F.diag_noise([0.05, 0.05, 0.02])
    for i in range(n - 1):
        F.add_between(gb, "se2", i, i + 1, se2.between(
            torch.tensor(truth[i]), torch.tensor(truth[i + 1])).numpy()
            + rng.normal(scale=0.005, size=3), noise)
    F.add_between(gb, "se2", 0, n - 1, se2.between(
        torch.tensor(truth[0]), torch.tensor(truth[-1])).numpy(), noise)
    F.add_between(gb, "se2", 1, 8, np.array([5.0, -3.0, 1.5]), noise)
    F.add_between(gb, "se2", 2, 9, np.array([-4.0, 2.0, -2.0]), noise)
    graph = FactorGraph(pri.batches + gb.build(
        device=dev, dtype=torch.float64).batches)
    init = truth + rng.normal(scale=0.05, size=truth.shape)
    return graph, values_from_numpy({"se2": init}, device=dev,
                                    dtype=torch.float64)


def _toy_constrained(dev):
    """test_constrained_noise.py's toy: two r2 priors, a soft between, the
    equality (x1 - x0)[0] = 3."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)

    def ix(a):
        return torch.tensor(a, device=dev)

    prior = lambda xs, m: xs[0] - m["p"]
    graph = FactorGraph([
        FactorBatch("prior0", prior, ("r2",), 2, ix([[0]]),
                    {"p": t([[1.0, 1.0]])}, NoiseModel("diag", t([[2.0,
                                                                   2.0]]))),
        FactorBatch("prior1", prior, ("r2",), 2, ix([[1]]),
                    {"p": t([[-1.0, 0.0]])}, NoiseModel("diag", t([[2.0,
                                                                    2.0]]))),
        FactorBatch("soft", lambda xs, m: xs[1] - xs[0] - m["m"],
                    ("r2", "r2"), 2, ix([[0, 1]]), {"m": t([[3.0, 0.0]])},
                    NoiseModel("diag", t([[0.0, 2.0]])))])
    cons = [FactorBatch("gap", lambda xs, m: (xs[1] - xs[0])[:1] - m["c"],
                        ("r2", "r2"), 1, ix([[0, 1]]), {"c": t([[3.0]])},
                        NoiseModel("unit"))]
    return graph, cons, Values({"r2": t(np.zeros((2, 2)))})


def _se2_stream(n, seed, step):
    rng = np.random.default_rng(seed)
    truth = [np.zeros(3)]
    for _ in range(n - 1):
        truth.append(se2.compose(torch.tensor(truth[-1]),
                                 torch.tensor(step)).numpy())
    truth = np.stack(truth)
    meas = [None] + [se2.between(torch.tensor(truth[i - 1]), torch.tensor(
        truth[i])).numpy() + rng.normal(scale=0.01, size=3)
        for i in range(1, n)]
    return truth, meas


def _stream_step(i, m, dev):
    gb = GraphBuilder()
    if m is None:
        F.add_prior(gb, "se2", 0, np.zeros(3), F.diag_noise([0.1, 0.1,
                                                             0.05]))
    else:
        F.add_between(gb, "se2", i - 1, i, m, F.diag_noise([0.05, 0.05,
                                                            0.02]))
    return gb.build(device=dev, dtype=torch.float64).batches


def _manhattan_stream(dev, n):
    """An IncrementalSmoother (the runner's settings) fed an n-pose
    Manhattan world's factors in the graph's order, as
    tests/test_incremental_runner.py feeds city10000's."""
    g, _, _ = manhattan.make_manhattan(n, seed=5, device="cpu",
                                       dtype=torch.float64)
    b = [x for x in g.batches if x.name == "between_se2"][0]
    ij, meas = b.idx.numpy(), b.meas["measured"].numpy()
    S = np.stack([np.diag(s) for s in b.noise.data.numpy()])
    inc = IncrementalSmoother("se2", device=dev)
    inc.set_prior(np.zeros(3), [0.3, 0.3, 0.1])
    for k in range(len(ij)):
        if ij[k, 1] == inc.n:
            inc.add_pose(se2.compose(torch.tensor(inc._poses[ij[k, 0]]),
                                     torch.tensor(meas[k])).numpy())
        inc.add_between(int(ij[k, 0]), int(ij[k, 1]), meas[k], S[k])
    return inc


def _breadth_cases():
    """name -> (fn(device) -> {key: numpy array}, tolerance): items 7-14 of
    the nonlinear breadth on their parity tests' problems."""
    def marginals_case(d):
        g, v = _chain_problem(d)
        return {"cov": marginals.all_marginal_covariances(g, v, "se2")
                .cpu().numpy()}

    def dogleg_case(d):
        g, v = pose2_tool.build(d)
        r = optimize_dogleg(g, v)
        return {"values": r.values["se2"].cpu().numpy()}

    def ncg_case(d):
        g, v = pose2_tool.build(d)
        r = optimize_ncg(g, v, optimizers.Params(max_iterations=200,
                                                 relative_error_tol=1e-8))
        return {"values": r.values["se2"].cpu().numpy(),
                "error": np.array(r.error)}

    def gnc_case(d):
        g, v = _gnc_problem(d)
        vals, w, _ = gnc.optimize_gnc(g, v, 1, gnc.GncParams())
        return {"values": vals["se2"].cpu().numpy(), "weights": w}

    def constrained_case(d):
        out = {}
        for method in ("penalty", "augmented_lagrangian"):
            g, cons, v = _toy_constrained(d)
            vals, _ = getattr(constrained, f"optimize_{method}")(g, v, cons)
            out[method] = vals["r2"].cpu().numpy()
        g, v = pose2_tool.build(d)
        eq = constrained.nonlinear_equality("se2", 0, np.array(
            [0.1, -0.2, 0.05]), device=d)
        out["equality"] = optimizers.optimize_lm(FactorGraph(
            g.batches[1:] + [eq]), v).values["se2"].cpu().numpy()
        return out

    def misc_case(d):
        rng = np.random.default_rng(0)
        A0, A1, b = rng.normal(size=(3, 3)), rng.normal(size=(3, 3)), \
            rng.normal(size=3)
        a0, a1 = rng.normal(size=3), rng.normal(size=3)
        gb = GraphBuilder()
        misc.add_linear_container(gb, ["r3", "r3"], [0, 1], [A0, A1], b,
                                  [a0, a1])
        F.add_prior(gb, "r3", 0, a0, F.diag_noise([1e-6] * 3))
        lc = optimizers.optimize_gn(gb.build(device=d, dtype=torch.float64),
                                    values_from_numpy({"r3": np.stack(
                                        [a0, a1])}, device=d,
                                        dtype=torch.float64),
                                    optimizers.Params(max_iterations=5))
        z = np.random.default_rng(1).normal(loc=2.5, scale=0.5, size=200)
        gb = GraphBuilder()
        for zk in z:
            gb.add("white_noise", misc.white_noise_residual, ("r1", "r1"), 2,
                   [0, 1], {"z": np.asarray(zk), "umax": np.log(1e8)},
                   {"kind": "unit"})
        wn = optimizers.optimize_lm(
            gb.build(device=d, dtype=torch.float64),
            values_from_numpy({"r1": np.zeros((2, 1))}, device=d,
                              dtype=torch.float64),
            optimizers.Params(max_iterations=300, relative_error_tol=1e-12,
                              absolute_error_tol=1e-12))
        return {"container": lc.values["r3"].cpu().numpy(),
                "white_noise": wn.values["r1"].cpu().numpy()}

    def fixed_lag_case(d):
        truth, meas = _se2_stream(10, 3, [1.0, 0.0, 0.05])
        sm = FixedLagSmoother(4.0, optimizers.Params(max_iterations=8))
        for i, m in enumerate(meas):
            sm.update(_stream_step(i, m, d), values_from_numpy(
                {"se2": truth[: i + 1]}, device=d, dtype=torch.float64),
                {("se2", i): float(i)})
        return {"estimate": sm.estimate()["se2"].cpu().numpy()}

    def incremental_case(d):
        inc = _manhattan_stream(d, 300)
        err = inc.solve(iters=8)
        return {"estimate": inc.estimate(), "error": np.array(err)}

    def concurrent_case(d):
        truth, meas = _se2_stream(10, 0, [1.0, 0.0, 0.1])
        cfs = ConcurrentFilterSmoother(4.0, 5, optimizers.Params(
            max_iterations=5))
        for i, m in enumerate(meas):
            cfs.update(_stream_step(i, m, d), values_from_numpy(
                {"se2": truth[: i + 1]}, device=d, dtype=torch.float64),
                {("se2", i): float(i)})
        cfs.run_smoother()
        cfs.synchronize()
        return {"smoothed": cfs.smoothed_estimate()["se2"].cpu().numpy(),
                "filtered": cfs.filtered_estimate()["se2"].cpu().numpy()}

    return {"marginals": (marginals_case, 1e-12),
            "dogleg": (dogleg_case, 1e-9), "ncg": (ncg_case, 1e-8),
            "gnc": (gnc_case, 1e-8), "constrained": (constrained_case, 1e-9),
            "misc": (misc_case, 1e-9), "fixed_lag": (fixed_lag_case, 1e-8),
            "incremental": (incremental_case, 1e-6),
            "concurrent": (concurrent_case, 1e-8)}


def phase_nonlinear_breadth(dev):
    """Items 7-14 of the nonlinear breadth card == CPU in float64 on their
    parity tests' problems, then the four data-free tools once on the
    card."""
    for name, (fn, tol) in _breadth_cases().items():
        t0 = time.perf_counter()
        c, h = fn(dev), fn(torch.device("cpu"))
        gap = max(float(np.abs(np.asarray(c[k]) - np.asarray(h[k])).max())
                  for k in c)
        print(f"[20] {name}: max |card - CPU| {gap:.2e} (limit {tol:g}) "
              f"over {', '.join(c)}; {_seconds_since(t0):.1f} s both")
        if not gap <= tol:
            raise RuntimeError(f"[20] {name}: card vs CPU {gap}")
    for tool in (pose2_tool, fixed_lag_tool, ik_tool, tutorials_tool):
        lines = []
        t0 = time.perf_counter()
        rec = tool.run(device=dev, say=lines.append)
        name = tool.__name__.rsplit(".", 1)[1]
        ok = rec.get("ok", True) if isinstance(rec, dict) else True
        print(f"[20] tools/{name}.py on the card: "
              f"{_seconds_since(t0):.1f} s; last line {lines[-1]!r}")
        if not ok:
            raise RuntimeError(f"[20] tools/{name}.py failed its check")


# --- phases 21-22: the linear-solver breadth ---------------------------------

ML_STATS = {"levels": 3, "parts": [48, 7, 5], "Dmax": [768, 624, 681],
            "sdmax": [1212, 2391, 2388], "root_dim": 5769}
ML_LAM = 1e-3
SPCG_MAXITER, SPCG_TOL = 200, 1e-8
SEQ_N = 2000            # poses of the sequential / QR comparison
SPCG_N = 300            # poses where SPCG converges inside its cap


def _rel_gap(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def _ml_split_ms(lin, plan, lam):
    """Milliseconds of one solve_ml by stage, CUDA events between the
    stages: assembly, each level's upward step, the root, the downward
    sweep."""
    lam = torch.as_tensor(lam, dtype=lin.batches[0].r.dtype,
                          device=lin.batches[0].r.device)
    events, names = [torch.cuda.Event(enable_timing=True)], []

    def mark(name):
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        names.append(name)
    torch.cuda.synchronize()
    events[0].record()
    fronts, rhs, root_sys, root_rhs = mlschur.assemble(lin, plan)
    mark("assembly")
    ys, Ws = [], []
    for lv in range(plan.L):
        y, W = mlschur.eliminate_level(lv, fronts, rhs, root_sys, root_rhs,
                                       plan, lam)
        ys.append(y)
        Ws.append(W)
        mark(f"level {lv}")
    sol = mlschur.solve_root(root_sys, root_rhs, plan, lam)
    mark("root")
    mlschur.back_substitute(sol, ys, Ws, plan)
    mark("downward")
    torch.cuda.synchronize()
    return {n: events[i].elapsed_time(events[i + 1])
            for i, n in enumerate(names)}


def _peak_of(fn):
    """Peak device MiB allocated during fn() above what was allocated
    before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _ml_solves(name, lin, plan, plan2):
    """solve_ml against solve_partitioned at lambda ML_LAM: their gap, each
    one's ms a call (CUDA events around 10 calls after a warm-up), the
    split of one solve_ml and the peaks; returns (gap, two-level step)."""
    d_ml = mlschur.solve_ml(lin, plan, ML_LAM)["se2"]
    d_2 = schur.solve_partitioned(lin, plan2, ML_LAM)["se2"]
    gap = _rel_gap(d_ml, d_2)
    ms_ml = _time_ms(lambda: mlschur.solve_ml(lin, plan, ML_LAM), 10, 1)
    ms_2 = _time_ms(lambda: schur.solve_partitioned(lin, plan2, ML_LAM),
                    10, 1)
    split = _ml_split_ms(lin, plan, ML_LAM)
    peak_ml = _peak_of(lambda: mlschur.solve_ml(lin, plan, ML_LAM))
    peak_2 = _peak_of(lambda: schur.solve_partitioned(lin, plan2, ML_LAM))
    print(f"[21] {name}, lambda {ML_LAM:g}: max |solve_ml - "
          f"solve_partitioned| / max |step| = {gap:.3e}; solve_ml "
          f"{ms_ml:.3f} ms a call, solve_partitioned {ms_2:.3f} ms "
          f"(CUDA events around 10 calls after a warm-up; ratio "
          f"{ms_ml / ms_2:.3f}); one solve_ml by stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" ms; peak above the linearization {peak_ml:.0f} MiB (two-level"
          f" {peak_2:.0f} MiB)")
    return gap, d_2


def _ml_lm(name, graph, initial, truth, plan, two_level_its):
    """Phase 7's LM run with the MLPlan: (err0, err, ATE)."""
    dts = []
    for _ in range(4):          # a warm-up run, then three timed runs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, lam, err, err0 = _pose_graph_run(graph, initial, plan, POSE_LAM0,
                                            POSE_ITERS)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    ate = metrics.ate(v["se2"][:, :2].cpu().numpy(), truth[:, :2])["rmse"]
    print(f"[21] {name}: lm_run with the MLPlan, error {float(err0):.6g} -> "
          f"{float(err):.10g}, lambda {float(lam):g}, ATE rmse {ate:.4f} m; "
          f"warm-up {dts[0]:.3f} s, then "
          + ", ".join(f"{POSE_ITERS / dt:.3f}" for dt in dts[1:])
          + " it/s (phase 7's two-level plan: "
          + ", ".join(f"{x:.3f}" for x in two_level_its[name]) + ")")
    return float(err0), float(err), ate


def _spcg(graph, initial, lin, d_2, label):
    """SPCG (linear/subgraph.py) in float64 at lambda ML_LAM, cap
    SPCG_MAXITER, tolerance SPCG_TOL; returns (PCG iterations, its
    relative gap to the two-level step d_2, block-Jacobi PCG's gap at the
    same cap)."""
    layout = Layout.of(initial)
    D = layout.total_dim
    need = 3 * D * D * 8            # H, its factor, the NaN-masked factor
    free = torch.cuda.mem_get_info()[0]
    print(f"[21] SPCG, {label}: the dense tree system is {D} x {D} "
          f"float64, {D * D * 8 / 1e9:.2f} GB; the factorization holds "
          f"about {need / 1e9:.1f} GB at its peak, {free / 1e9:.1f} GB free")
    if need > free:
        raise RuntimeError(f"[21] SPCG needs {need} bytes, {free} free")
    dev = initial["se2"].device
    masks, t_sel = _timed(lambda: subgraph.build_spanning_tree_selection(
        graph.batches, initial.counts()), "cpu")
    precond, t_fac = _timed(lambda: subgraph.SubgraphPreconditioner(
        lin, masks, layout, ML_LAM), dev)
    b = {g: -x for g, x in lin.gradient_at_zero().items()}
    threshold = (SPCG_TOL * torch.sqrt(tree_vdot(b, b))) ** 2
    (x, used), t_pcg = _timed(lambda: solvers.pcg_loop(
        solvers.make_damped_matvec(lin, ML_LAM, None), precond.apply,
        {g: torch.zeros_like(v) for g, v in b.items()}, b, threshold,
        SPCG_MAXITER), dev)
    del precond
    d, t_all = _timed(lambda: subgraph.solve_spcg(
        lin, masks, layout, lam=ML_LAM, maxiter=SPCG_MAXITER,
        tol=SPCG_TOL)["se2"], dev)
    jacobi = solvers.solve_pcg(lin, ML_LAM, maxiter=SPCG_MAXITER,
                               tol=SPCG_TOL)["se2"]
    used, gap, gap_j = int(used), _rel_gap(d, d_2), _rel_gap(jacobi, d_2)
    print(f"[21] SPCG, {label}: {sum(int(m.sum()) for m in masks)} tree "
          f"factors of {graph.num_factors}; tree selection {t_sel:.2f} s "
          f"(host), factor {t_fac:.3f} s, {used} PCG iterations (cap "
          f"{SPCG_MAXITER}, tolerance {SPCG_TOL:g}) in {t_pcg:.3f} s; "
          f"solve_spcg whole {t_all:.3f} s; max |spcg - partitioned| / max "
          f"|step| = {gap:.3e}, block-Jacobi PCG at the same cap "
          f"{gap_j:.3e}; |solve_spcg - the loop| "
          f"{float((d - x['se2']).abs().max()):.1e}")
    if not (torch.isfinite(d).all() and gap < gap_j):
        raise RuntimeError(f"gate: [21] SPCG {label}: gap {gap}, "
                           f"block-Jacobi's {gap_j}")
    return used, gap


def _spcg_converged(dev):
    """SPCG at SPCG_N poses, where its cap suffices: gate, converged
    inside the cap and within 1e-6 of solve_partitioned."""
    graph, initial, _ = manhattan.make_manhattan(SPCG_N, seed=42, device=dev,
                                                 dtype=torch.float64)
    lin = linearize(graph, initial)
    d_2 = schur.solve_partitioned(lin, schur.make_plan(
        graph, initial.counts(), max_part_size=POSE_PART), ML_LAM)["se2"]
    used, gap = _spcg(graph, initial, lin, d_2, f"{SPCG_N} poses")
    if not (used < SPCG_MAXITER and gap <= 1e-6):
        raise RuntimeError(f"gate: [21] SPCG at {SPCG_N} poses: {used} "
                           f"iterations, gap {gap}")


def _sequential_qr(dev):
    """optimize_lm with solver "schur", "sequential" and "qr" in float64 on
    the SEQ_N-pose graph: the same final error (1e-9 relative)."""
    graph, initial, _ = manhattan.make_manhattan(SEQ_N, seed=42, device=dev,
                                                 dtype=torch.float64)
    plan = schur.make_plan(graph, initial.counts(), max_part_size=POSE_PART)
    res = {}
    for solver in ("schur", "sequential", "qr"):
        r, dt = _timed(lambda: optimizers.optimize_lm(
            graph, initial, optimizers.Params(solver=solver),
            plan=plan if solver == "schur" else None), dev)
        res[solver] = r
        print(f"[21] {SEQ_N} poses, float64, optimize_lm solver={solver}: "
              f"error {r.error:.12g} in {r.iterations} iterations, "
              f"{dt:.3f} s")
    e = res["schur"].error
    for solver in ("sequential", "qr"):
        if not abs(res[solver].error - e) <= 1e-9 * e:
            raise RuntimeError(f"gate: [21] {solver} error "
                               f"{res[solver].error} vs schur {e}")


def phase_ml(dev, two_level_e64, two_level_its):
    """The multi-level Schur solver on phase 7's graph: plan, solves, LM;
    SPCG at full size; sequential and QR elimination at SEQ_N poses."""
    n, counts = POSE_N, {"se2": POSE_N}
    runs = {}
    plan = plan2 = None
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        graph, initial, truth = manhattan.make_manhattan(
            n, seed=42, device=dev, dtype=dtype)
        if plan is None:            # the plans hold structure only
            t0 = time.perf_counter()
            plan = mlschur.make_ml_plan(graph, counts, max_part_size=POSE_PART)
            t_plan = time.perf_counter() - t0
            plan2 = schur.make_plan(graph, counts, max_part_size=POSE_PART)
            print(f"[21] MLPlan of phase 7's graph (parts <= {POSE_PART}) "
                  f"built on the host in {t_plan:.2f} s: {plan.stats()}")
            if plan.stats() != ML_STATS:
                raise RuntimeError(f"gate: [21] plan stats {plan.stats()} "
                                   f"!= the JAX plan's {ML_STATS}")
        lin = linearize(graph, initial)
        gap, d_2 = _ml_solves(name, lin, plan, plan2)
        if dtype == torch.float64 and not gap <= 1e-9:
            raise RuntimeError(f"gate: [21] float64 solve_ml vs "
                               f"solve_partitioned {gap}")
        runs[name] = _ml_lm(name, graph, initial, truth, plan, two_level_its)
        if dtype == torch.float64:
            # a record: the iterations grow with the loops (146, 378 and
            # 1789 at 300, 600 and 2000 poses on the CPU), so the cap
            # leaves it unconverged here; gated: finite, closer than
            # block-Jacobi PCG at the same cap
            _spcg(graph, initial, lin, d_2, f"{n} poses")
        del graph, initial, lin, d_2
        torch.cuda.empty_cache()
    e0, e32, ate32 = runs["float32"]
    _, e64, _ = runs["float64"]
    if not (np.isfinite(e32) and e32 < e0):
        raise RuntimeError(f"gate: [21] error {e0} -> {e32}")
    if not abs(e32 - e64) <= 1e-3 * abs(e64):
        raise RuntimeError(f"gate: [21] float32 {e32} vs float64 {e64}")
    if not ate32 < 0.5:
        raise RuntimeError(f"gate: [21] ATE rmse {ate32:.4f} m >= 0.5 m")
    if not abs(e64 - two_level_e64) <= 1e-9 * two_level_e64:
        raise RuntimeError(f"gate: [21] float64 error {e64} vs the two-level "
                           f"{two_level_e64}")
    print(f"[21] gates passed: stats, float64 solve gap, LM (float32 vs "
          f"float64 rel {abs(e32 - e64) / abs(e64):.2e}, ATE {ate32:.4f} m, "
          f"float64 vs phase 7's two-level error rel "
          f"{abs(e64 - two_level_e64) / two_level_e64:.2e}), SPCG")
    _spcg_converged(dev)
    _sequential_qr(dev)


def _toy_equality(dev):
    """tests/test_constrained_noise.py's toy: soft priors and a between
    factor whose first row is an exact constraint."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float64), device=dev)
    prior = lambda xs, m: xs[0] - m["p"]
    ix = lambda a: torch.tensor(a, device=dev)
    return FactorGraph([
        FactorBatch("prior0", prior, ("r2",), 2, ix([[0]]),
                    {"p": t([[1.0, 1.0]])}, NoiseModel("diag", t([2.0, 2.0]))),
        FactorBatch("prior1", prior, ("r2",), 2, ix([[1]]),
                    {"p": t([[-1.0, 0.0]])}, NoiseModel("diag",
                                                        t([2.0, 2.0]))),
        FactorBatch("between01", lambda xs, m: (xs[1] - xs[0]) - m["m"],
                    ("r2", "r2"), 2, ix([[0, 1]]), {"m": t([[3.0, 0.0]])},
                    noise_mod.constrained_sigmas([0.0, 0.5], device=dev,
                                                 dtype=torch.float64))]), \
        Values({"r2": t(np.zeros((2, 2)))})


def _linear_cases():
    """name -> (fn(device) -> {key: numpy array}, tolerance): the Part B
    modules on their parity tests' problems, in float64."""
    f64 = torch.float64

    def host(d):
        return {k: np.asarray(v.detach().cpu().numpy()
                              if isinstance(v, torch.Tensor) else v)
                for k, v in d.items()}

    def conditional_case(d):
        g, v, _ = manhattan.make_manhattan(100, seed=3, device=d, dtype=f64)
        lin, layout = linearize(g, v), Layout.of(v)
        ch = conditional.eliminate_sequential(lin, layout, lam=1e-6)
        qr = conditional.eliminate_sequential(lin, layout, lam=1e-6,
                                              method="qr")
        rng = np.random.default_rng(0)
        rhs = {"se2": torch.tensor(rng.normal(size=(100, 3)), device=d)}
        eps = torch.tensor(rng.normal(size=300), device=d)
        return host({
            "R_chol": ch.Rmat, "R_qr": qr.Rmat, "d_chol": ch.dvec,
            "d_qr": qr.dvec, "optimize": ch.optimize()["se2"],
            "qr_optimize": qr.optimize()["se2"],
            "gradient_search": ch.optimize_gradient_search()["se2"],
            "back_substitute": ch.back_substitute(rhs)["se2"],
            "back_substitute_transpose":
                ch.back_substitute_transpose(rhs)["se2"],
            "stepwise": ch.optimize_stepwise()["se2"],
            "log_determinant": ch.log_determinant(),
            "sample": ch.sample_from(eps)["se2"]})

    def equality_case(d):
        g, v = _toy_equality(d)
        layout = Layout.of(v)
        lin, E, e = conditional.split_constrained(g, v, layout)
        return host({"E": E, "e": e, "x": conditional.
                     solve_equality_constrained(lin, layout, E, e)["r2"]})

    def diagnostics_case(d):
        out = {}
        for label, meas in (("orphan", 1.0), ("nan", float("nan"))):
            gb = GraphBuilder()
            F.add_prior(gb, "se2", 0, np.zeros(3), F.diag_noise([1.0] * 3))
            for i in range(3):
                F.add_between(gb, "se2", i, i + 1, np.array([meas, 0, 0]),
                              F.diag_noise([0.1, 0.1, 0.05]))
            vals = np.random.default_rng(0).normal(scale=0.1, size=(5, 3))
            rep = diagnostics.diagnose(gb.build(device=d, dtype=f64),
                                       values_from_numpy({"se2": vals},
                                                         device=d,
                                                         dtype=f64))
            out[f"{label}_rows"] = [r for _, r in rep.nonfinite_factors]
            out[f"{label}_vars"] = [i for _, i, _ in rep.singular_variables]
            out[f"{label}_eigs"] = [e for *_, e in rep.singular_variables]
            out[f"{label}_min"] = rep.min_block_eig
        return host(out)

    def mlschur_case(d):
        g, v, _ = manhattan.make_manhattan(300, seed=3, device=d, dtype=f64)
        lin = linearize(g, v)
        out = {}
        for label, args in (("four_levels", (12, 24, 5)),
                            ("all_root", (64, 10 ** 6, 4))):
            plan = mlschur.make_ml_plan(g, v.counts(), *args)
            if plan.L != (4 if label == "four_levels" else 0):
                raise RuntimeError(f"[22] {label}: {plan.stats()}")
            out[label] = mlschur.solve_ml(lin, plan, 1e-3)["se2"]
        return host(out)

    def spcg_case(d):
        g, v, _ = manhattan.make_manhattan(100, seed=3, device=d, dtype=f64)
        masks = subgraph.build_spanning_tree_selection(g.batches, v.counts())
        return host({"x": subgraph.solve_spcg(
            linearize(g, v), masks, Layout.of(v), lam=1e-6, maxiter=300,
            tol=1e-12)["se2"]})

    def kalman_case(d):
        def t(a):
            return torch.tensor(np.asarray(a, dtype=np.float64), device=d)
        eye = np.eye(2)
        final, means = kalman.kf_run(
            kalman.GaussianState(t(np.zeros(2)), t(0.01 * eye)), t(eye),
            t(eye), t(0.01 * eye), t(eye), t(0.0625 * eye),
            t(np.tile([1.0, 0.0], (3, 1))), t([[1.0, 0], [2.0, 0],
                                               [3.0, 0]]))
        ekf = kalman.ExtendedKalmanFilter("se2", t([0.1, -0.2, 0.3]),
                                          t(0.1 * np.eye(3)))
        for z in np.random.default_rng(4).normal(size=(5, 2)):
            ekf.predict(lambda x: se2.compose(x, t([1.0, 0.1, 0.2])),
                        t(np.diag([0.01, 0.01, 0.004])))
            ekf.update(lambda x: x[:2], t(z), t(0.05 * eye))
        return host({"kf_mean": final.mean, "kf_cov": final.cov,
                     "kf_means": means, "ekf_mean": ekf.state.mean,
                     "ekf_cov": ekf.state.cov})

    def sampler_case(d):
        rng = np.random.default_rng(5)
        model = noise_mod.covariance([[2.0, 0.5], [0.5, 1.0]], device=d,
                                     dtype=f64)
        z = torch.tensor(rng.normal(size=(1000, 2)), device=d)
        w = torch.tensor([0.01, 0.01, 10.0, 0.01, 3.0], device=d)
        u = torch.tensor(rng.uniform(1e-12, 1.0, size=5), device=d)
        return host({"noise": sampler.noise_from_standard(model, z),
                     "order": sampler.weighted_keys_order(w, u, 5)})

    def lpqp_case(d):
        A_in = torch.tensor([[1.0, 1.0]], device=d, dtype=f64)
        res = lpqp.solve_qp(2 * torch.eye(2, device=d, dtype=f64),
                            torch.tensor([-4.0, -4.0], device=d), A_in=A_in,
                            b_in=torch.tensor([2.0], device=d))
        return {"x": res.x}

    return {"conditional": (conditional_case, 1e-9),
            "equality": (equality_case, 1e-12),
            "diagnostics": (diagnostics_case, 1e-9),
            "mlschur": (mlschur_case, 1e-9), "spcg": (spcg_case, 1e-9),
            "kalman": (kalman_case, 1e-12), "sampler": (sampler_case, 1e-12),
            "lpqp": (lpqp_case, 0.0)}


def phase_linear_breadth(dev):
    """The linear breadth card == CPU in float64 on the parity tests'
    problems."""
    def gap_of(a, b):
        """max |a - b| where NaN == NaN (the diagnosis reports NaN
        eigenvalues); infinite where only one side is NaN."""
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, np.float64)
        na, nb = np.isnan(a), np.isnan(b)
        if (na != nb).any():
            return float("inf")
        d = np.abs(a - b)[~na]
        return float(d.max()) if d.size else 0.0

    for name, (fn, tol) in _linear_cases().items():
        t0 = time.perf_counter()
        c, h = fn(dev), fn(torch.device("cpu"))
        gap = max(gap_of(c[k], h[k]) for k in c)
        print(f"[22] {name}: max |card - CPU| {gap:.2e} (limit {tol:g}) "
              f"over {', '.join(c)}; {_seconds_since(t0):.1f} s both")
        if not gap <= tol:
            raise RuntimeError(f"[22] {name}: card vs CPU {gap}")


def phase_solver_comparer(dev, tmp):
    """tools/solver_comparer.py on the card on a SEQ_N-pose file of
    write_g2o_2d: every solver and the incremental stream, then a second
    run's snapshot against the first's."""
    graph, values, _ = manhattan.make_manhattan(SEQ_N, seed=42, device=dev,
                                                dtype=torch.float64)
    path, snap_a, snap_b = (f"{tmp}/m{SEQ_N}.g2o", f"{tmp}/A", f"{tmp}/B")
    dataset.write_g2o_2d(path, values, graph)
    lines = []
    t0 = time.perf_counter()
    rec = comparer_tool.run(path, solvers="dense,schur,pcg,qr,sequential",
                            with_incremental=True, snapshot=snap_a,
                            device=dev, say=lines.append)
    comparer_tool.run(path, solvers="sequential", snapshot=snap_b,
                      device=dev, say=lines.append)
    diff = comparer_tool.compare(snap_a, snap_b, say=lines.append)["se2"][0]
    for line in lines:
        print(f"[22] solver_comparer: {line}")
    direct = max(rec["diffs"][s] for s in ("schur", "qr", "sequential"))
    print(f"[22] tools/solver_comparer.py on the card, {SEQ_N} poses: "
          f"{_seconds_since(t0):.1f} s; direct solvers' max parameter "
          f"difference {direct:.2e} (limit 1e-6), snapshots A (best: "
          f"{rec['best']}) vs B max |diff| {diff:.2e} (limit 1e-6)")
    if not direct <= 1e-6:
        raise RuntimeError(f"gate: [22] direct solvers differ by {direct}")
    if not diff <= 1e-6:
        raise RuntimeError(f"gate: [22] snapshots differ by {diff}")


# phase 23: the camera-major engine's run on phase 5's problem
CM_ITERS = 10
# phase 24: lines of the timed hybrid stream (the example's default is 150)
HYBRID_TIMED_LINES = 500


def _ladybug(dtype, dev):
    """Phase 5's problem: (BalProblem, BAState, BAObservations)."""
    prob = synthetic.make_skewed_problem(
        num_cameras=1723, num_points=156000, mean_track=4.0, max_track=40,
        seed=2, cam_zipf=1.2)
    return (prob, *ba.state_from_bal(prob, device=dev, dtype=dtype))


class _Split:
    """The probe of ba.optimize_ba: a CUDA event at each label, the time
    between consecutive events charged to the later label (linearize,
    precond, pcg, error), and CG's iteration counts."""

    def __init__(self):
        self.events = [("start", torch.cuda.Event(enable_timing=True))]
        self.events[0][1].record()
        self.iterations = []

    def __call__(self, label, iterations=None, **_):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((label, e))
        if iterations is not None:
            self.iterations.append(iterations)

    def totals(self):
        torch.cuda.synchronize()
        out = {}
        for (_, a), (label, b) in zip(self.events, self.events[1:]):
            out[label] = out.get(label, 0.0) + a.elapsed_time(b)
        return out


def phase_cm(dev, tmp):
    """The camera-major engine (sfm/ba.py:optimize_ba) at full size in
    float32, its card == CPU check and tools/sfm_example_bal.py with both
    engines."""
    t0 = time.perf_counter()
    prob, state, obs = _ladybug(torch.float32, dev)
    layout = ba.make_layout(obs, prob.num_cameras, prob.num_points)
    err_init = float(ba.ba_error(state, obs))
    print(f"[23] problem C={layout.C} P={layout.P} M={layout.M} built in "
          f"{_seconds_since(t0):.1f} s; initial error {err_init:.6g}")
    ba.optimize_ba(state, obs, layout, max_iterations=1)   # warm-up
    split = _Split()
    landmark_block_solve.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, err, its = ba.optimize_ba(state, obs, layout, max_iterations=CM_ITERS,
                                 probe=split)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = landmark_block_solve.launches
    tries = len(split.iterations)
    cg = [int(k) for k in split.iterations]
    ms = split.totals()
    rms = float(np.sqrt(2.0 * err / layout.M))
    print(f"[23] optimize_ba (lambda0 1e-4, cg_maxiter 100, tol 1e-6): "
          f"error {err_init:.6g} -> {err:.6g}, rms {rms:.4f} px, {its} "
          f"iterations, {tries} tries in {dt:.3f} s: {dt / tries:.4f} s a "
          f"try")
    print(f"[23] split by CUDA events, ms a try: "
          + ", ".join(f"{k} {v / tries:.3f}" for k, v in ms.items())
          + f" (linearize once an iteration: {ms.get('linearize', 0) / its:.3f}"
          f" ms an iteration)")
    print(f"[23] PCG iterations a try: mean {np.mean(cg):.1f}, "
          f"min {min(cg)}, max {max(cg)}; landmark_block_solve launches "
          f"{launches} ({launches / tries:.1f} a try: 2 + 1 a PCG "
          f"iteration)")
    if not np.isfinite(err):
        raise RuntimeError(f"gate: [23] non-finite error {err}")
    if not err < err_init:
        raise RuntimeError(f"gate: [23] error did not decrease: {err_init} "
                           f"-> {err}")
    if not rms < 1.3:
        raise RuntimeError(f"gate: [23] rms reprojection {rms:.4f} px >= "
                           f"1.3 px")
    if launches <= 0:
        raise RuntimeError("[23] the camera-major engine launched no "
                           "landmark_block_solve kernel")
    del state, obs, layout

    small = synthetic.make_skewed_problem(
        num_cameras=29, num_points=300, mean_track=4.0, max_track=24, seed=5,
        cam_zipf=1.2)
    out = {}
    for d in (dev, torch.device("cpu")):
        st, ob = ba.state_from_bal(small, device=d, dtype=torch.float64)
        pl = ba.make_layout(ob, small.num_cameras, small.num_points)
        xc, xp = ba.solve_ba_step_cm(st, ob, pl, 1.0, cg_maxiter=300,
                                     cg_tol=1e-12)
        e = ba.ba_error_cm(ba.retract_ba(st, xc, xp), ob, pl)
        out[d.type] = [x.cpu() for x in (xc, xp, e)]
    gap = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))
              for a, b in zip(out["cuda"], out["cpu"]))
    print(f"[23] 29-camera float64 step (lambda 1, CG to 1e-12) and the "
          f"error after it: card vs CPU {gap:.2e} of the largest entry "
          f"(limit 1e-9)")
    if not gap <= 1e-9:
        raise RuntimeError(f"gate: [23] card vs CPU {gap}")

    t0 = time.perf_counter()
    path = f"{tmp}/ladybug_standin.txt"
    bal.write_bal(path, prob)
    print(f"[23] write_bal of the problem: {_seconds_since(t0):.1f} s")
    for engine in ("pack", "cm"):
        lines = []
        rec = sfm_tool.run(path, CM_ITERS, engine, device=dev,
                           say=lines.append)
        for line in lines:
            print(f"[23] sfm_example_bal --engine {engine}: {line}")
        if not rec["final"] < rec["initial"]:
            raise RuntimeError(f"gate: [23] sfm_example_bal --engine "
                               f"{engine} did not decrease")
    return launches, tries


def phase_lm_jit(dev):
    """optimize_lm_jit against optimize_lm on phase 7's graph, float64."""
    graph, initial, _ = manhattan.make_manhattan(POSE_N, seed=42, device=dev,
                                                 dtype=torch.float64)
    plan = schur.make_plan(graph, {"se2": POSE_N}, max_part_size=POSE_PART)
    params = optimizers.Params(solver="schur", lambda_initial=POSE_LAM0,
                               max_iterations=POSE_ITERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = optimizers.optimize_lm(graph, initial, params, plan)
    t_lm = _seconds_since(t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, err, it = optimizers.optimize_lm_jit(graph, initial, params,
                                            plan=plan)
    err = float(err)
    t_jit = _seconds_since(t0)
    rel = abs(err - res.error) / res.error
    print(f"[24] optimize_lm_jit on phase 7's {POSE_N}-pose graph (schur, "
          f"lambda0 {POSE_LAM0:g}, at most {POSE_ITERS} iterations), "
          f"float64: error {err:.10g} in {it} iterations, {t_jit:.2f} s; "
          f"optimize_lm {res.error:.10g} in {res.iterations} iterations, "
          f"{t_lm:.2f} s; relative gap {rel:.2e} (limit 1e-9)")
    if not rel <= 1e-9:
        raise RuntimeError(f"gate: [24] optimize_lm_jit vs optimize_lm "
                           f"{rel}")


def phase_hybrid(dev, tmp):
    """tools/hybrid_city10000.py on the stand-in: both engines card == CPU
    at the example's 150 lines, then a timed ISAM2 stream."""
    path = f"{tmp}/city10000_hybrid.txt"
    true_modes = write_city10000_hybrid(path)
    recs = {}
    for engine in ("isam", "smoother"):
        for d in (dev, torch.device("cpu")):
            lines = []
            t0 = time.perf_counter()
            rec = hybrid_tool.run(path, 150, 4, engine, d, lines.append)
            recs[engine, d.type] = rec
            if d.type == "cuda":
                for line in "\n".join(lines).splitlines():
                    print(f"[24] hybrid_city10000 --engine {engine}: {line}")
            print(f"[24] --engine {engine} on the {d.type}: "
                  f"{_seconds_since(t0):.1f} s")
        a, b = recs[engine, "cuda"], recs[engine, "cpu"]
        rel = abs(a["error"] - b["error"]) / b["error"]
        print(f"[24] --engine {engine}, 150 lines: card vs CPU error "
              f"{rel:.2e} (limit 1e-9), modes equal: "
              f"{a['assignment'] == b['assignment']}")
        want = {k: true_modes[k] for k in a["assignment"]}
        if a["assignment"] != b["assignment"] or not rel <= 1e-9:
            raise RuntimeError(f"gate: [24] {engine} card vs CPU")
        if a["assignment"] != want or a["modes"] < 3:
            raise RuntimeError(f"gate: [24] {engine} picked "
                               f"{a['assignment']}, the truth is {want}")
    chain.chain_factorize.launches = 0
    lines = []
    rec = hybrid_tool.run(path, HYBRID_TIMED_LINES, 4, "isam", dev,
                          lines.append)
    launches = chain.chain_factorize.launches
    for line in "\n".join(lines).splitlines():
        print(f"[24] timed --max-lines {HYBRID_TIMED_LINES}: {line}")
    print(f"[24] timed stream: {rec['edges']} edges, {rec['modes']} mode "
          f"variables, {rec['ms_per_edge']:.2f} ms an edge, "
          f"chain_factorize launches {launches}")
    want = {k: true_modes[k] for k in rec["assignment"]}
    if rec["assignment"] != want:
        raise RuntimeError(f"gate: [24] timed stream picked "
                           f"{rec['assignment']}, the truth is {want}")
    if launches <= 0:
        raise RuntimeError("[24] the hybrid stream launched no "
                           "chain_factorize kernel")
    return launches


def _library_cases(tmp):
    """Phase 25's problems, each a function of the device returning
    {name: array}; the QPS file is written under `tmp`."""
    rng = np.random.default_rng(21)
    cards = rng.integers(2, 4, 8)
    factors = [((v,), rng.uniform(0.2, 2.0, cards[v])) for v in range(8)]
    for _ in range(6):
        vs = tuple(int(x) for x in rng.choice(8, 2 + int(rng.integers(2)),
                                              replace=False))
        factors.append((vs, rng.uniform(0.1, 3.0, tuple(cards[list(vs)]))))
    us = rng.uniform(size=8)

    def discrete_case(d):
        g = discrete.factor_graph_from_numpy(factors, device=d)
        bn, _ = g.eliminate(g.variables())
        out = {f"marginal{v}": g.marginal(v).cpu().numpy()
               for v in g.variables()}
        out["mpe"] = np.array(list(g.optimize().values()))
        out["k_best"] = np.array([p for _, p in g.k_best(5)])
        out["sample"] = np.array(list(bn.sample_from_uniforms(us).values()))
        return out

    def csp_case(d):
        s = csp.Scheduler(3, ["Frank", "Harvey", "Ron", "Ken"], device=d)
        s.add_student("Alice", {"AI": ["Frank", "Harvey"],
                                "Robotics": ["Ron", "Frank"]},
                      advisor="Frank")
        s.add_student("Bob", {"Vision": ["Ken", "Harvey"]},
                      available_slots=[0, 2])
        sol = s.schedule()
        return {"slots": np.array([sol[k]["slot"] for k in sorted(sol)])}

    def chebyshev_case(d):
        xs = np.linspace(-0.9, 0.9, 25)
        coeffs, _ = chebyshev.fit_basis(xs, np.sin(2 * xs), 8, device=d)
        return {"coeffs": coeffs,
                "D": chebyshev.chebyshev2_differentiation_matrix(
                    8, device=d).cpu().numpy(),
                "w": chebyshev.chebyshev2_weights(
                    xs, 8, device=d).cpu().numpy()}

    def qps_case(d):
        path = f"{tmp}/tiny.qps"
        with open(path, "w") as f:
            f.write(QPS_TEXT)
        x, obj = qps.solve_qps(path)
        return {"x": x, "obj": np.array([obj])}

    def keys_symbolic_dot_case(d):
        sg = symbolic.SymbolicFactorGraph(
            [(i, i + 1) for i in range(11)] + [(0, 6), (3, 9)])
        bn, fill = sg.eliminate(sg.default_ordering())
        graph, _, _ = manhattan.make_manhattan(60, seed=3, device=d,
                                               dtype=torch.float64)
        text = dotw.to_dot(graph)
        return {"keys": np.array([keys.Symbol("x", 5).key(),
                                  keys.EdgeKey(3, 4).key()], dtype=np.uint64),
                "fill": np.array([fill, len(bn)]),
                "dot": np.frombuffer(text.encode(), dtype=np.uint8)}

    return {"discrete": discrete_case, "csp": csp_case,
            "chebyshev": chebyshev_case, "qps": qps_case,
            "keys, symbolic, dot": keys_symbolic_dot_case}


QPS_TEXT = """NAME          TINYQP
ROWS
 N  obj
 L  c1
 E  c2
COLUMNS
    x1        obj       -1.0       c1        1.0
    x1        c2        1.0
    x2        obj       -2.0       c1        1.0
    x2        c2        -1.0
RHS
    rhs       c1        4.0        c2        0.2
BOUNDS
 UP bnd       x1        3.0
QUADOBJ
    x1        x1        2.0
    x2        x2        1.0
ENDATA
"""


def phase_library(dev, tmp):
    """The rest of the library card == CPU in float64, and
    tools/discrete_examples.py on the card."""
    for name, fn in _library_cases(tmp).items():
        t0 = time.perf_counter()
        c, h = fn(dev), fn(torch.device("cpu"))
        gap = max(float(np.abs(c[k].astype(np.float64)
                               - h[k].astype(np.float64)).max())
                  if c[k].shape == h[k].shape else float("inf") for k in h)
        print(f"[25] {name}: max |card - CPU| {gap:.2e} (limit 1e-12) over "
              f"{', '.join(sorted(h))}; {_seconds_since(t0):.1f} s both")
        if not gap <= 1e-12:
            raise RuntimeError(f"[25] {name}: card vs CPU {gap}")
    lines = []
    ok = discrete_tool.run(dev, lines.append)
    for line in lines:
        print(f"[25] discrete_examples: {line}")
    if not ok:
        raise RuntimeError("[25] discrete_examples failed its checks")


def breadth_child(tmp):
    """Phases 19 (its card == CPU part and a record), 20 and 22 in a fourth
    process: they time nothing that is gated."""
    torch.set_num_threads(2)
    dev = config.device("cuda")
    phase_shonan_parity(dev, tmp)
    phase_nonlinear_breadth(dev)
    phase_linear_breadth(dev)
    phase_library(dev, tmp)


def hybrid_child(tmp):
    """Phase 24's hybrid City10000 stream (card == CPU at 150 lines, then
    timed at HYBRID_TIMED_LINES) in a sixth process beside phases 16-17:
    a host-bound stream of ISAM2 updates, ~130-160 s. Its
    chain_factorize launches go to TMP/hybrid.json. One CPU thread."""
    torch.set_num_threads(1)
    launches = phase_hybrid(config.device("cuda"), tmp)
    with open(f"{tmp}/hybrid.json", "w") as f:
        json.dump({"chain_factorize_launches": launches}, f)


def comparer_child(tmp):
    """Phase 22's solver_comparer run in a fifth process: its incremental
    stream (an ISAM2 update a measurement, 3380 of them) takes minutes of
    host-bound updates, which beside phases 16-18 cost no wall time. One
    CPU thread."""
    torch.set_num_threads(1)
    phase_solver_comparer(config.device("cuda"), tmp)


# phase 26: the distributed paths, DIST_RANKS ranks sharing the one card
DIST_RANKS = 4
DIST_ITERS, DIST_CG = 10, 2     # phase 5's LM run
DIST_SCHUR_LAM = 1e-3
DIST_GRAPH_POSES = 300          # phase 6's graph, (d)'s sharded step
# (d)'s PCG runs to convergence (~410 iterations): cut at 1e-10 (~364), the
# two steps, whose sums differ in order, can stop an iteration apart, and
# their iterates are then up to 2.1e-10 apart, above (d)'s 1e-10 gate
DIST_GRAPH_TOL = 1e-14


def _max_gap(pairs):
    return max(float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())
               for a, b in pairs)


def _gate(label, gap, limit):
    if not gap <= limit:
        raise RuntimeError(f"gate: [26] {label}: {gap} above {limit}")


def _mesh_ms(fn, mesh, n):
    """ms a call of fn on every rank: the ranks start together after a
    barrier, the time runs to the card's synchronize after n calls."""
    fn()
    dist_ba.sync(mesh)
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dist_ba.sync(mesh)
    return 1e3 * (time.perf_counter() - t0) / n


def dist_parity(mesh, say):
    """(a) float64, the ranks against the port's single-device functions
    on the card, on the JAX tests' problems, CG to 1e-12 for the steps."""
    dev = mesh.device
    prob = synthetic.make_skewed_problem(
        num_cameras=29, num_points=300, mean_track=4.0, max_track=24, seed=5,
        cam_zipf=1.2)
    C, P = prob.num_cameras, prob.num_points
    state, obs = ba.state_from_bal(prob, device=dev, dtype=torch.float64)
    pl = ba_pack.make_pack_layout(obs, C, P)
    sp = dist_ba.pad_cameras(state, mesh.size)
    dpl = dist_ba_pack.build_dist_pack_layout(obs, C, P, mesh)
    xc_r, xp_r = ba_pack.solve_ba_step_pk(state, obs, pl, 1e-4, cg_maxiter=20,
                                          cg_tol=1e-12)
    xc, xp = dist_ba_pack.dist_pack_solve_step(sp, dpl, 1e-4, mesh,
                                               cg_maxiter=20, cg_tol=1e-12)
    step_gap = _max_gap([(xc[:C], xc_r), (xp, xp_r), (xc[C:], 0.0)])
    _gate("dist_pack_solve_step", step_gap, 1e-8)
    err0 = ba_pack.ba_error_pk(state, obs, pl)
    st_r, lam_r, err_r = ba_pack.ba_lm_run_pk(state, obs, pl, 1e-3, err0,
                                              n_iters=5, cg_maxiter=8)
    e0 = dist_ba_pack.dist_pack_error(sp, dpl, mesh)
    st, lam, err = dist_ba_pack.dist_pack_lm_run(sp, dpl, 1e-3, e0, 5, mesh,
                                                 cg_maxiter=8)
    lam_gap = abs(float(lam) / float(lam_r) - 1.0)
    err_gap = abs(float(err) / float(err_r) - 1.0)
    state_gap = _max_gap([(st.cam_poses[:C], st_r.cam_poses),
                          (st.cam_cals[:C], st_r.cam_cals),
                          (st.points, st_r.points)])
    _gate("dist_pack_lm_run lambda", lam_gap, 1e-12)
    _gate("dist_pack_lm_run error", err_gap, 1e-8)
    _gate("dist_pack_lm_run state", state_gap, 1e-8)
    say(f"[26] (a) 29-camera float64, {mesh.size} ranks against the "
        f"single-device engine on the card: dist_pack_solve_step (CG to "
        f"1e-12) {step_gap:.2e} (limit 1e-8; boundary {dpl.Ps} of {P} "
        f"landmarks); dist_pack_lm_run, 5 iterations: lambda {lam_gap:.1e} "
        f"relative (1e-12), error {err_gap:.1e} relative (1e-8; "
        f"{float(err):.10g}), state {state_gap:.2e} (1e-8)")

    ring = synthetic.make_ring_problem(num_cameras=19, num_points=80,
                                       obs_per_point=4, seed=11)
    rs, ro = ba.state_from_bal(ring, device=dev, dtype=torch.float64)
    layout = ba.make_layout(ro, 19, 80)
    xc_r, xp_r = ba.solve_ba_step_cm(rs, ro, layout, 1e-4, cg_maxiter=30,
                                     cg_tol=1e-12)
    dl = dist_ba.build_dist_layout(ro, 19, 80, mesh)
    xc, xp = dist_ba.dist_solve_ba_step(dist_ba.pad_cameras(rs, mesh.size),
                                        dl, 1e-4, mesh, cg_maxiter=30,
                                        cg_tol=1e-12)
    ring_gap = _max_gap([(xc[:19], xc_r), (xp, xp_r)])
    _gate("dist_solve_ba_step", ring_gap, 1e-8)
    one = pmesh.Mesh(None, 0, 1, dev)
    lone = dist_ba_pack.build_dist_pack_layout(obs, C, P, one)
    xc_r, xp_r = ba_pack.solve_ba_step_pk(state, obs, pl, 3e-4, cg_maxiter=12,
                                          cg_tol=1e-12)
    xc, xp = dist_ba_pack.dist_pack_solve_step(state, lone, 3e-4, one,
                                               cg_maxiter=12, cg_tol=1e-12)
    lone_gap = _max_gap([(xc, xc_r), (xp, xp_r)])
    if lone.Ps != 0:
        raise RuntimeError(f"[26] a world of one has {lone.Ps} boundary "
                           f"landmarks")
    _gate("world of one", lone_gap, 1e-8)
    say(f"[26] (a) 19-camera ring: dist_solve_ba_step against "
        f"solve_ba_step_cm (CG to 1e-12) {ring_gap:.2e} (limit 1e-8, "
        f"boundary {dl.Ps} of 80); a world of one (Ps = 0) against "
        f"solve_ba_step_pk {lone_gap:.2e} (1e-8)")


def dist_main(mesh, say):
    """(b) dist_pack_lm_run at full width on phase 5's problem, float32,
    balanced dealing: a warm-up run, then a timed run, under phase 5's
    gates, and the collectives' share. Returns the record that the main
    process prints beside phase 5's."""
    dev = mesh.device
    t0 = time.perf_counter()
    prob, state, obs = _ladybug(torch.float32, dev)
    C, P, M = prob.num_cameras, prob.num_points, obs.cam.numel()
    sp = dist_ba.pad_cameras(state, mesh.size)
    dpl = dist_ba_pack.build_dist_pack_layout(obs, C, P, mesh)
    contiguous = dist_ba_pack.build_dist_pack_layout(obs, C, P, mesh,
                                                     balanced=False)
    err0 = dist_ba_pack.dist_pack_error(sp, dpl, mesh)
    err_init = float(err0)
    dealt = {}
    for name, d in (("balanced", dpl), ("contiguous", contiguous)):
        rows = np.asarray(d.rows)
        dealt[name] = {"Ps": d.Ps, "boundary_share": d.Ps / P,
                       "rows": d.rows,
                       "rows_max_over_mean": float(rows.max() / rows.mean())}
    say(f"[26] (b) problem C={C} P={P} M={M} dealt over {mesh.size} ranks "
        f"in {_seconds_since(t0):.1f} s; initial error {err_init:.6g}")
    for name, d in dealt.items():
        say(f"[26] (b) {name} dealing: boundary Ps = {d['Ps']} of {P} "
            f"landmarks ({100 * d['boundary_share']:.2f}%), rows a rank "
            f"{list(d['rows'])}, max over mean {d['rows_max_over_mean']:.4f}")
    dist_ba.sync(mesh)
    t0 = time.perf_counter()
    dist_pack_lm = dist_ba_pack.dist_pack_lm_run
    dist_pack_lm(sp, dpl, 1e-3, err0, DIST_ITERS, mesh, cg_maxiter=DIST_CG)
    dist_ba.sync(mesh)
    warm = time.perf_counter() - t0
    mesh.barrier()
    landmark_block_solve.launches = 0
    t0 = time.perf_counter()
    _, lam, err = dist_pack_lm(sp, dpl, 1e-3, err0, DIST_ITERS, mesh,
                               cg_maxiter=DIST_CG)
    dist_ba.sync(mesh)
    dt = time.perf_counter() - t0
    launches = landmark_block_solve.launches
    total, launched = mesh.psum(torch.tensor(
        [float(launches), float(launches > 0)], dtype=torch.float64,
        device=dev)).tolist()
    err_final = float(err)
    rms = float(np.sqrt(2.0 * err_final / M))
    say(f"[26] (b) warm-up run of {DIST_ITERS} iterations: {warm:.3f} s")
    say(f"[26] (b) error {err_init:.6g} -> {err_final:.6g}, rms {rms:.4f} "
        f"px, lambda {float(lam):g}; {DIST_ITERS} timed LM iterations "
        f"(cg={DIST_CG}) in {dt:.4f} s: {DIST_ITERS / dt:.3f} it/s; "
        f"landmark_block_solve launches {launches} on rank 0, {int(total)} "
        f"over the {mesh.size} ranks, every rank: {launched == mesh.size}")
    if not np.isfinite(err_final):
        raise RuntimeError(f"gate: [26] non-finite BA error {err_final}")
    if not err_final < err_init:
        raise RuntimeError(f"gate: [26] BA error did not decrease: "
                           f"{err_init} -> {err_final}")
    if not rms < 1.3:
        raise RuntimeError(f"gate: [26] rms reprojection {rms:.4f} px")
    if launched != mesh.size:
        raise RuntimeError(f"[26] landmark_block_solve launched on "
                           f"{int(launched)} of {mesh.size} ranks")
    t_full, t_local, frac = dist_ba_pack.collective_overhead(
        sp, dpl, mesh, lam=1e-4, cg_maxiter=10, iters=3)
    say(f"[26] (b) collective_overhead (dist_pack_solve_step, cg 10, means "
        f"over the ranks): full {1e3 * t_full:.3f} ms, without the "
        f"all-reduces {1e3 * t_local:.3f} ms, fraction {frac:.4f}. The "
        f"{mesh.size} ranks share one card and their all-reduces go "
        f"through host memory ({dist.get_backend()}): not an NVLink figure")
    return {"launches_dist": int(total), "it_s": DIST_ITERS / dt,
            "seconds": dt, "err_init": err_init, "err_final": err_final,
            "rms": rms, "lam": float(lam), "dealing": dealt,
            "collective_overhead": [t_full, t_local, frac]}


def dist_schur_phase(mesh, say):
    """(c) phase 7's 10000-pose graph, float64: the sharded partitioned
    Schur solve against solve_partitioned, both timed, and the
    collectives' share."""
    dev = mesh.device
    graph, initial, _ = manhattan.make_manhattan(POSE_N, seed=42, device=dev,
                                                 dtype=torch.float64)
    plan = schur.make_plan(graph, {"se2": POSE_N}, max_part_size=POSE_PART)
    lin = linearize(graph, initial)
    dplan = dist_schur.DistSchurPlan(plan, mesh)
    lam = DIST_SCHUR_LAM
    got = dist_schur.solve_partitioned_sharded(lin, dplan, mesh, lam)
    single_ms = gap = float("nan")
    if mesh.rank == 0:          # the others wait at the barrier below
        ref = schur.solve_partitioned(lin, plan, lam)
        gap = _max_gap([(got["se2"], ref["se2"])])
        _gate("solve_partitioned_sharded", gap, 1e-9)
        single_ms = _mesh_ms(lambda: schur.solve_partitioned(lin, plan, lam),
                             pmesh.Mesh(None, 0, 1, dev), 5)
    mesh.barrier()
    sharded_ms = _mesh_ms(lambda: dist_schur.solve_partitioned_sharded(
        lin, dplan, mesh, lam), mesh, 5)
    t_full, t_local, frac = dist_schur.collective_overhead(lin, dplan, mesh,
                                                           lam=lam, iters=5)
    say(f"[26] (c) {POSE_N}-pose graph, {plan.p} parts of at most "
        f"{POSE_PART} poses, separator {plan.S_dim}, float64, lambda {lam:g}, "
        f"{mesh.size} ranks ({dplan.pp} parts a rank): sharded == "
        f"solve_partitioned to {gap:.2e} (limit 1e-9); {single_ms:.3f} ms a "
        f"call alone, {sharded_ms:.3f} ms sharded; collective_overhead full "
        f"{1e3 * t_full:.3f} ms, without the all-reduces "
        f"{1e3 * t_local:.3f} ms, fraction {frac:.4f} (one card, the "
        f"all-reduces through the host)")


def dist_graph(mesh, say):
    """(d) shard_graph: one sharded LM step of phase 6's graph, float64,
    against the single-device step; sharded_ba_step against ba_try_step
    on the 16-camera ring."""
    dev = mesh.device
    graph, initial, _ = manhattan.make_manhattan(
        DIST_GRAPH_POSES, seed=3, device=dev, dtype=torch.float64)
    lin = linearize(graph, initial)
    v1 = initial.retract(solvers.solve_pcg(lin, 1e-4, maxiter=1000,
                                           tol=DIST_GRAPH_TOL))
    e1 = float(graph.error(v1))
    v, e = pmesh.sharded_step(pmesh.shard_graph(graph, mesh), initial, 1e-4,
                              mesh, maxiter=1000, tol=DIST_GRAPH_TOL)
    gap = _max_gap([(v["se2"], v1["se2"])])
    err_gap = abs(float(e) / e1 - 1.0)
    _gate("sharded_step", gap, 1e-10)
    _gate("sharded_step error", err_gap, 1e-10)
    ring = synthetic.make_ring_problem(num_cameras=16, num_points=64,
                                       obs_per_point=4, seed=5)
    rs, ro = ba.state_from_bal(ring, device=dev, dtype=torch.float64)
    layout = ba.make_layout(ro, 16, 64)
    s1, re1 = ba.ba_try_step(rs, ro, layout, 1e-4, cg_maxiter=50)
    st, ob, dl = ba_sharded.shard_ba(rs, ro, layout, mesh)
    s2, re2 = ba_sharded.sharded_ba_step(st, ob, dl, 1e-4, cg_maxiter=50)
    ba_gap = _max_gap([(s2.points, s1.points),
                       (s2.cam_poses[:16], s1.cam_poses)])
    ba_err_gap = abs(float(re2) / float(re1) - 1.0)
    _gate("sharded_ba_step", ba_gap, 1e-8)
    _gate("sharded_ba_step error", ba_err_gap, 1e-8)
    say(f"[26] (d) shard_graph: one LM step of the {DIST_GRAPH_POSES}-pose "
        f"graph (lambda 1e-4, PCG to {DIST_GRAPH_TOL:g}) on {mesh.size} "
        f"ranks against the single-device step: poses {gap:.2e}, error "
        f"{err_gap:.1e} relative (limits 1e-10); sharded_ba_step against "
        f"ba_try_step on the 16-camera ring: state {ba_gap:.2e}, error "
        f"{ba_err_gap:.1e} (1e-8)")


def dist_rank(rank, port, tmp):
    """One rank of phase 26: join the group (gloo when the ranks outnumber
    the cards; every rank on cuda:0 here), run (a)-(d); rank 0 prints and
    writes (b)'s record to TMP/dist.json."""
    torch.set_num_threads(1)
    bootstrap.maybe_init_distributed(f"localhost:{port}", DIST_RANKS, rank)
    try:
        mesh = pmesh.make_mesh()

        def say(line):
            if rank == 0:
                print(line, flush=True)
        say(f"[26] {mesh.size} ranks, backend {dist.get_backend()}, every "
            f"rank on {mesh.device} ({torch.cuda.get_device_name(0)}): the "
            f"all-reduces go through host memory")
        dist_parity(mesh, say)
        rec = dist_main(mesh, say)
        dist_schur_phase(mesh, say)
        dist_graph(mesh, say)
        if rank == 0:
            with open(f"{tmp}/dist.json", "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# phase 27: the last seven tools of examples/
TOOL_VIS_POSES, TOOL_VIS_POINTS = 40, 32    # visual_isam2's timed size
# the parity tests' cut sizes (tests/test_torch_tools_{files,small}.py)
TOOL_CUT_VO = {"n_factors": 400, "n_landmarks": 150}
TOOL_CUT_VICTORIA, TOOL_CUT_PLAZA2, TOOL_CUT_M3500 = 800, 500, 600
# CG run to convergence in the ISAM2 streams, where two implementations
# are compared (ROADMAP queue 3 A7), as phases 9 and 18 run it
ISAM2_CONVERGED = {"cg_maxiter": 300, "cg_tol": 1e-10}
# Plaza2's limits (stream error and batch error relative, estimates in
# m): the range-only problem is ill-conditioned (range sigma 100 m under
# Tukey against odometry sigmas of 0.01-0.1), so two float64
# factorizations of its batch start differ by 5e-12 to 1.1e-10 relative
# in the error, and the stream, seeded with that start, ends 1e-8 to 5e-8
# m apart (CPU against the JAX package, card against CPU) with CG run to
# convergence: CG is not what separates them
PLAZA2_LIMITS = (1e-7, 1e-8, 1e-6)
# numbers below this are float noise at an exact optimum (spcg's 7e-30,
# view_graph's 1e-18): two runs print different digits of zero
TOOL_TINY = 1e-12
# view_graph's edges one and two poses apart: the 96 transfer factors
# leave the two-apart edges undetermined beyond ~1e-5 (LM moves them
# along a direction of nearly zero curvature, by float noise over lambda),
# so their errors are held to the example's gate, 1e-4
VIEW_GRAPH_LOOSE = [(r"^  edge \(\d, \d\)", 1e-4)]
_NUM = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
TOOL_MODULES = {m.__name__.rsplit(".", 1)[1]: m for m in (
    stereo_vo_large, victoria_park, range_isam_plaza2, visual_isam2,
    pose2_m3500, view_graph, parity_suite)}


def untimed(line):
    """A tool's line with its wall time and rate masked."""
    line = re.sub(r"\d+(?:\.\d+)? poses/s", "R poses/s", line)
    return re.sub(r"\d+(?:\.\d+)?s\b", "Ts", line)


def tool_lines_gap(got, want, loose=()):
    """The pairs of lines that differ between two runs of a tool, wall
    times masked. Numbers must print the same, but where both are below
    TOOL_TINY in magnitude, or where the line matches a pattern of `loose`
    [(regex, atol)] and the two are within atol."""
    bad = [] if len(got) == len(want) else [(len(got), len(want))]
    for g, w in zip(got, want):
        g, w = untimed(g), untimed(w)
        if g == w:
            continue
        gn, wn = _NUM.findall(g), _NUM.findall(w)
        atol = max([a for rx, a in loose if re.search(rx, w)] + [0.0])
        same = (_NUM.sub("#", g) == _NUM.sub("#", w) and len(gn) == len(wn)
                and all(a == b or (abs(float(a)) < TOOL_TINY
                                   and abs(float(b)) < TOOL_TINY)
                        or abs(float(a) - float(b)) <= atol
                        for a, b in zip(gn, wn)))
        if not same:
            bad.append((g, w))
    return bad


def _host_blocks(values):
    return {g: values[g].cpu().numpy() for g in values.groups()}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def tool_record_gap(name, a, b):
    """(what, gap, limit) triples holding two runs of a tool: records of
    run() on the card and on the CPU, or the port's against the JAX
    example's numbers in the tests (the same keys). Direct solves in
    float64: the error to 1e-9 relative and the variables to 1e-8; the
    ISAM2 streams, CG run to convergence (ISAM2_CONVERGED): their error
    to 1e-9 relative and estimates to 1e-8 (Plaza2: PLAZA2_LIMITS)."""
    out = []
    if name in ("stereo_vo_large", "victoria_park", "pose2_m3500"):
        out.append(("error", _rel(a["error"], b["error"]), 1e-9))
        va, vb = a["values"], b["values"]
        for g in va:
            out.append((g, float(np.abs(va[g] - vb[g]).max()), 1e-8))
    elif name in ("range_isam_plaza2", "visual_isam2"):
        lim = PLAZA2_LIMITS if name == "range_isam_plaza2" else (1e-9, 1e-9,
                                                                  1e-8)
        out.append(("error", _rel(a["error"], b["error"]), lim[0]))
        out.append(("batch error", _rel(a["batch"], b["batch"]), lim[1]))
        for g in a["estimate"]:
            out.append((g, float(np.abs(a["estimate"][g]
                                        - b["estimate"][g]).max()), lim[2]))
    elif name == "view_graph":
        out.append(("iterations", abs(a["iterations"] - b["iterations"]), 0))
        out.append(("error", max(a["error"], b["error"]), TOOL_TINY))
        # F up to its sign (the example's comparison)
        Fa, Fb = np.asarray(a["F"])[:4], np.asarray(b["F"])[:4]
        Fa = Fa * np.sign((Fa * Fb).sum((1, 2)))[:, None, None]
        out.append(("edges one pose apart", float(np.abs(Fa - Fb).max()),
                    1e-8))
    return out


def tool_numbers(name, rec):
    """The numbers tool_record_gap holds, from a port tool's record, as
    numpy."""
    if name in ("stereo_vo_large", "victoria_park"):
        return {"error": rec["error"], "values": _host_blocks(rec["values"])}
    if name == "pose2_m3500":
        r = rec["result"]
        return {"error": r.error, "values": _host_blocks(r.values)}
    if name in ("range_isam_plaza2", "visual_isam2"):
        return {"error": rec["error"], "batch": rec["batch"].error,
                "estimate": _host_blocks(rec["isam"].calculate_estimate())}
    r = rec["result"]
    return {"iterations": r.iterations, "error": r.error,
            "F": fundamental_mod.fundamental_matrix(
                r.values["fundamental"]).cpu().numpy()}


def _tool_run(name, dev, data_dir, say_prefix=None, **kw):
    """Run tools/<name>.py's run() on `dev` with its data in
    `data_dir`/data, its lines printed after `say_prefix` (if one is
    given); returns (record, lines, seconds)."""
    mod = TOOL_MODULES[name]
    lines = []
    cwd = os.getcwd()
    os.chdir(data_dir)
    try:
        t0 = time.perf_counter()
        rec = mod.run(device=dev, say=lines.append, **kw)
        _sync(dev)
        dt = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    for s in lines if say_prefix else ():
        print(f"{say_prefix} {s}")
    return rec, lines, dt


def _parity_gap(a, b):
    """Largest gap between two parity-suite records of one subcommand."""
    gaps = [0.0]
    for k, v in a.items():
        if k == "segments":
            continue
        x, y = np.asarray(v, dtype=np.float64), np.asarray(b[k],
                                                           dtype=np.float64)
        scale = max(1.0, float(np.abs(y).max()))
        gaps.append(float(np.abs(x - y).max()) / scale)
    return max(gaps)


def phase_tools(dev, tmp):
    """Phase 27: the seven tools on the card at full stand-in size under
    their own gates, then card == CPU at the parity tests' cut sizes;
    preint_tangent against its plain version on combined_imu's segments.
    Returns the record written to TMP/tools.json."""
    full, cut = f"{tmp}/tools_full", f"{tmp}/tools_cut"
    for d in (full, cut):
        os.makedirs(f"{d}/data")
    t0 = time.perf_counter()
    write_tool_data(f"{full}/data")
    write_vo_large(f"{cut}/data", **TOOL_CUT_VO)
    for name in ("victoria_park.txt", "noisyToyGraph.txt",
                 "pose3example.txt", "Plaza2_DR.txt", "Plaza2_TD.txt"):
        os.link(f"{full}/data/{name}", f"{cut}/data/{name}")
    print(f"[27] stand-ins written in {_seconds_since(t0):.1f} s: VO "
          f"{VO_POSES} poses / {VO_FACTORS} factors / {VO_LANDMARKS} "
          f"landmarks, Victoria Park {VICTORIA_POSES} poses / "
          f"{VICTORIA_LANDMARKS} landmarks, Plaza2 {PLAZA2_STEPS} steps / "
          f"{PLAZA2_RANGES} ranges")
    rec = {"seconds": {}}
    runs = [("stereo_vo_large", {}), ("victoria_park", {}),
            ("range_isam_plaza2", {}), ("visual_isam2", {}),
            ("visual_isam2", {"poses": TOOL_VIS_POSES,
                              "points": TOOL_VIS_POINTS}),
            ("pose2_m3500", {"n": 3500, "solver": "schur"}),
            ("view_graph", {})]
    for name, kw in runs:
        label = name + "".join(f" --{k} {v}" for k, v in kw.items())
        out, _, dt = _tool_run(name, dev, full, f"[27] {label}:", **kw)
        if not out["ok"]:
            raise RuntimeError(f"gate: [27] {label} printed FAIL")
        rec["seconds"][label] = dt
        print(f"[27] {label}: OK in {dt:.2f} s on the card")
        if name == "visual_isam2" and kw:
            rec["visual_update_ms"] = 1e3 * float(np.mean(out["update_s"]))
            print(f"[27] {label}: {len(out['update_s'])} updates, "
                  f"{rec['visual_update_ms']:.2f} ms an update, "
                  f"{TOOL_VIS_POSES / out['seconds']:.2f} poses/s; error "
                  f"{out['error']:.6f} against batch {out['batch'].error:.6f}")
        if name == "range_isam_plaza2":
            print(f"[27] {label}: {out['updates']} updates, "
                  f"{PLAZA2_STEPS / out['seconds']:.1f} poses/s")
    vo, _, dt = _tool_run("stereo_vo_large", dev, full)
    rec["seconds"]["stereo_vo_large (second run)"] = dt
    rec["vo_split_ms"] = _vo_split(dev, full)
    print(f"[27] stereo_vo_large, a second run in the same process: "
          f"{dt:.2f} s ({vo['iterations']} iterations); one dense LM try "
          f"at {vo['values'].tangent_dim()} tangent dimensions, ms: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rec["vo_split_ms"].items()))
    preint_ops.preint_tangent.launches = 0
    suite, suite_lines, dt = _tool_run("parity_suite", dev, full,
                                       "[27] parity_suite:")
    launches = preint_ops.preint_tangent.launches
    rec["seconds"]["parity_suite"] = dt
    rec["launches_tools"] = launches
    print(f"[27] parity_suite: 11 subcommands OK in {dt:.2f} s on the card; "
          f"preint_tangent.launches = {launches}")
    if launches <= 0:
        raise RuntimeError("[27] combined_imu launched no preint_tangent")
    segs = suite["combined_imu"]["segments"]
    args = [torch.tensor(np.stack([s[i] for s in segs]), device=dev)
            for i in range(3)]
    bias = torch.zeros(len(segs), 6, device=dev, dtype=torch.float64)
    covs = pre.PreintegrationParams.make_shared_u(
        g=9.81, accel_sigma=0.02, gyro_sigma=0.002, device=dev).covs(args[0])
    got = preint_ops.preint_tangent(*args, bias, covs)
    ref = preint_ops.preint_tangent_ref(*args, bias, covs)
    gap = max(float((g - r).abs().max() / r.abs().max().clamp(min=1e-300))
              for g, r in zip(got, ref))
    rec["preint_gap"] = gap
    print(f"[27] preint_tangent == plain version on combined_imu's "
          f"{len(segs)} segments of {args[0].shape[1]} samples (float64): "
          f"{gap:.2e} of the largest entry (limit 1e-10)")
    if not gap <= 1e-10:
        raise RuntimeError(f"gate: [27] preint_tangent {gap}")

    # card == CPU at the tests' cut sizes; every comparison runs, then any
    # that failed raises
    failed = []
    cpu = torch.device("cpu")
    cut_runs = [("stereo_vo_large", {}),
                ("victoria_park", {"n": TOOL_CUT_VICTORIA}),
                ("range_isam_plaza2", {"steps": TOOL_CUT_PLAZA2,
                                       **ISAM2_CONVERGED}),
                ("visual_isam2", ISAM2_CONVERGED),
                ("pose2_m3500", {"n": TOOL_CUT_M3500, "solver": "dense"}),
                ("view_graph", {})]
    for name, kw in cut_runs:
        t1 = time.perf_counter()
        outs, lines = [], []
        for d in (dev, cpu):
            o, ln, _ = _tool_run(name, d, cut, **kw)
            outs.append(tool_numbers(name, o))
            lines.append(ln)
        bad = tool_lines_gap(lines[0], lines[1],
                             VIEW_GRAPH_LOOSE if name == "view_graph"
                             else ())
        gaps = tool_record_gap(name, *outs)
        worst = ", ".join(f"{w} {g:.2e} (limit {lim:g})"
                          for w, g, lim in gaps)
        print(f"[27] {name} card == CPU at the tests' cut size "
              f"({_seconds_since(t1):.1f} s): lines "
              f"{'equal' if not bad else bad}; {worst}")
        if bad or any(not g <= lim for _, g, lim in gaps):
            failed.append(name)
    t1 = time.perf_counter()
    cpu_suite, cpu_lines, _ = _tool_run("parity_suite", cpu, full)
    bad = tool_lines_gap(suite_lines, cpu_lines)
    gap = max(_parity_gap(suite[k], cpu_suite[k]) for k in suite)
    print(f"[27] parity_suite card == CPU ({_seconds_since(t1):.1f} s): "
          f"lines {'equal' if not bad else bad}; records within {gap:.2e} "
          f"of their largest entry (limit 1e-8)")
    if bad or not gap <= 1e-8:
        failed.append("parity_suite")
    if failed:
        raise RuntimeError(f"gate: [27] card != CPU: {failed}")
    return rec


def _vo_split(dev, full):
    """ms of the stages of one dense LM try of stereo_vo_large at full
    size (synchronized host clocks): linearize, assemble the normal
    equations, factor and solve, retract and the error."""
    cwd = os.getcwd()
    os.chdir(full)
    try:
        graph, init, _ = stereo_vo_large.build(dev, say=_quiet)
    finally:
        os.chdir(cwd)
    layout = Layout.of(init)
    out = {}
    for _ in range(2):              # the second pass is the one kept
        lin, t_lin = _timed(lambda: linearize(graph, init), dev)
        (H, g), t_asm = _timed(lambda: lin.assemble_dense(layout), dev)

        def solve():
            H.diagonal().add_(1e-5)
            return torch.cholesky_solve(-g[:, None], solvers.cholesky_nan(H))
        d, t_sol = _timed(solve, dev)
        _, t_err = _timed(lambda: graph.error(init.retract(
            layout.unflatten(d[:, 0]))), dev)
        out = {"linearize": 1e3 * t_lin, "assemble": 1e3 * t_asm,
               "factor+solve": 1e3 * t_sol, "retract+error": 1e3 * t_err}
    return out


def tools_child(tmp):
    """Phase 27 in an eighth process beside phases 16-17; its record to
    TMP/tools.json. Two CPU threads: the card == CPU half runs the tools
    on the CPU."""
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    rec = phase_tools(config.device("cuda"), tmp)
    rec["child_seconds"] = _seconds_since(t0)
    print(f"[clock] phase 27's process: {rec['child_seconds']:.1f} s")
    with open(f"{tmp}/tools.json", "w") as f:
        json.dump(rec, f)


def dist_child(tmp):
    """Phase 26 in a seventh process beside phases 16-17: spawns
    DIST_RANKS ranks once and runs every part in them; a rank that fails
    makes this process exit non-zero. One CPU thread a rank."""
    t0 = time.perf_counter()
    _build.build()              # built by the main process; ranks load it
    torch.multiprocessing.spawn(dist_rank, args=(_free_port(), tmp),
                                nprocs=DIST_RANKS, join=True)
    print(f"[clock] phase 26's process: {_seconds_since(t0):.1f} s")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    dev = config.device("cuda")
    card = card_line()
    print(card)
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")
    t0 = time.perf_counter()

    def clock(after):
        print(f"[clock] {time.perf_counter() - t0:.1f} s at the end of "
              f"phase {after}")
    phase_build()
    record = phase_kernel(dev)
    phase_parity(dev)
    launches, ba_error = phase_main(dev)
    phase_pose_parity(dev)
    phase_se3_parity(dev)
    batch_optimum, pose_its = phase_pose_main(dev)
    chain_record = phase_chain(dev)
    clock(8)
    with tempfile.TemporaryDirectory() as tmp:
        chain_launches = phase_isam_main(dev, batch_optimum)
        clock(10)
        phase_file_2d(dev, batch_optimum, tmp)
        phase_file_3d(dev, tmp)
    phase_breadth(dev)
    clock(13)
    tangent_record, rotation_record, rotation_launches = phase_preint(dev)
    clock(14)
    with tempfile.TemporaryDirectory() as tmp:
        phase_shonan(dev, tmp)
    clock(19)
    phase_ml(dev, batch_optimum, pose_its)
    clock(21)
    with tempfile.TemporaryDirectory() as tmp:
        cm_launches, cm_tries = phase_cm(dev, tmp)
    clock(23)
    phase_lm_jit(dev)
    clock("24 (optimize_lm_jit)")
    # the kernels are timed: phases 9 and 15 (parity, untimed), phase 18's
    # full-size stream, phase 19's parity with phases 20, 22 and 25, phase
    # 22's solver_comparer run and phase 24's hybrid stream in five more
    # processes beside 16 and 17
    with tempfile.TemporaryDirectory() as tmp:
        children = [start_child(kind, tmp) for kind in CHILDREN]
        try:
            phase_vio_batch(dev, tmp)
            clock(16)
            tangent_launches, cap, d = phase_vio_stream(dev, tmp)
            clock(17)
            phase_smart(dev, children[0], tmp)
            clock(18)
            join_child(children[1])
            clock("9 and 15")
            join_child(children[2])
            clock("19 (card == CPU), 20 and 22")
            join_child(children[3])
            clock("22 (solver_comparer)")
            join_child(children[4])
            clock("24 (the hybrid stream)")
            with open(f"{tmp}/hybrid.json") as f:
                hybrid_launches = json.load(f)["chain_factorize_launches"]
            join_child(children[5])
            clock("26 (the distributed paths)")
            with open(f"{tmp}/dist.json") as f:
                dist_rec = json.load(f)
            print(f"[26] (b) {DIST_RANKS} ranks on one card: final error "
                  f"{dist_rec['err_final']:.6g} at {dist_rec['it_s']:.3f} "
                  f"it/s; phase 5, one process: {ba_error:.6g}")
            join_child(children[6])
            clock("27 (the seven tools)")
            with open(f"{tmp}/tools.json") as f:
                tools_rec = json.load(f)
        finally:
            for _, proc, _ in children:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
    chain_time_stream(dev, cap, d)
    print(card)
    print(json.dumps({"kernels": [
        {"name": "landmark_block_solve", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
         "launches": launches, **record,
         "launches_from": "phase 5, the timed BA LM run",
         "launches_cm": cm_launches,
         "launches_cm_from": f"phase 23, the camera-major engine's "
                             f"{CM_ITERS} iterations ({cm_tries} tries)",
         "launches_dist": dist_rec["launches_dist"],
         "launches_dist_from": f"phase 26 (b), dist_pack_lm_run's "
                               f"{DIST_ITERS} timed iterations, summed over "
                               f"its {DIST_RANKS} ranks"},
        {"name": "chain_factorize", "route": "cuda",
         "source": CHAIN_SOURCE, "replaces": CHAIN_REPLACES,
         "launches": chain_launches, **chain_record,
         "launches_from": "phase 10, the 10000-pose ISAM2 stream",
         "launches_hybrid": hybrid_launches,
         "launches_hybrid_from": f"phase 24, the hybrid City10000 stream "
                                 f"at {HYBRID_TIMED_LINES} lines"},
        {"name": "preint_tangent", "route": "cuda",
         "source": PREINT_T_SOURCE, "replaces": PREINT_T_REPLACES,
         "launches": tangent_launches, **tangent_record,
         "launches_from": f"phase 17, the {VIO_STREAM_FIXES}-fix IMU + GPS "
                          f"ISAM2 stream, a segment a launch; the times are "
                          f"of that launch (phase 14), batch_launch's of "
                          f"phase 14's 2000 segments, phase 16's shape",
         "launches_tools": tools_rec["launches_tools"],
         "launches_tools_from": "phase 27, tools/parity_suite.py on the "
                                "card (combined_imu: a launch a keyframe)"},
        {"name": "preint_rotation", "route": "cuda",
         "source": PREINT_R_SOURCE, "replaces": PREINT_R_REPLACES,
         "launches": rotation_launches, **rotation_record,
         "launches_from": "phase 14: integrate_manifold_batch and "
                          "integrate_ahrs_batch; no path of the tools runs "
                          "the manifold backend or AHRS"}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        if sys.argv[2] == "smart":
            smart_stream_child(f"{sys.argv[3]}/smart_stream.json")
        elif sys.argv[2] == "breadth":
            breadth_child(sys.argv[3])
        elif sys.argv[2] == "comparer":
            comparer_child(sys.argv[3])
        elif sys.argv[2] == "hybrid":
            hybrid_child(sys.argv[3])
        elif sys.argv[2] == "dist":
            dist_child(sys.argv[3])
        elif sys.argv[2] == "tools":
            tools_child(sys.argv[3])
        else:
            parity_child(sys.argv[3])
    else:
        main()
