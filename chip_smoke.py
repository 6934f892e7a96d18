#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gtsam_personal_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. require CUDA (there is no CPU fallback) and print the card's name and
     power limit as nvidia-smi reports them;
  2. build the CUDA kernel from csrc/ with nvcc for sm_90a (set-up time);
  3. hold the kernel against its plain torch version on the card at
     P = 156000 and P = 77 in float64 and float32, and time both at
     P = 156000 in float32 with CUDA events;
  4. one LM step and 5 LM iterations on a 29-camera problem in float64, on
     the card and on the CPU: the two must agree;
  5. the main path at full size: bundle adjustment LM on the skewed
     Ladybug-1723-scale synthetic problem (1723 cameras, 156k landmarks,
     ~529k observations) in float32, lambda0 = 1e-3, 2 CG iterations, one
     warm-up run of 10 iterations, then 10 timed iterations, under the
     gates of bench.py: the error is finite, it decreases, and the rms
     reprojection error is below 1.3 px.

The last two lines are a JSON record of the kernels
({"kernels": [...]}, with the launch count from the timed run of phase 5)
and {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.ops import _build
from gtsam_personal_tpu_torch.ops.block_solve import (
    landmark_block_solve, landmark_block_solve_ref)
from gtsam_personal_tpu_torch.sfm import ba, ba_pack, synthetic

KERNEL_SOURCE = "gtsam_personal_tpu_torch/csrc/landmark_block_solve.cu"
KERNEL_REPLACES = "gtsam_personal_tpu/ops/pallas_kernels.py:23"
P_FULL = 156000
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


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
    """Mean milliseconds per call over n calls, by CUDA events."""
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


def phase_kernel(dev):
    """Kernel == plain version on the card; returns (max_abs_err, ms,
    plain_ms) at P = 156000 in float32."""
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
    fns = {"kernel": landmark_block_solve, "plain": landmark_block_solve_ref}
    readings = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = fns[name]
        readings[name].append(_time_ms(lambda: fn(H, t, lam_t)))
    ms, plain_ms = (float(np.mean(readings[k])) for k in ("kernel", "plain"))
    print(f"[3] float32 P={P_FULL}: kernel {ms * 1e3:.2f} us/call, plain "
          f"torch {plain_ms * 1e3:.2f} us/call (CUDA events, mean of 200 "
          f"calls; readings in ms {readings})")
    return errs[(torch.float32, P_FULL)], ms, plain_ms


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    dev = config.device("cuda")
    print(card_line())
    print(f"[1] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")
    phase_build()
    max_abs_err, ms, plain_ms = phase_kernel(dev)
    phase_parity(dev)
    launches = phase_main(dev)
    print(json.dumps({"kernels": [{
        "name": "landmark_block_solve", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
