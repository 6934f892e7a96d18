"""Where the time of the pose-graph batch LM goes on one CUDA card.

    python -m gtsam_personal_tpu_torch.tools.profile_pose_graph

Runs the configuration of chip_smoke.py phase 7, which takes its sizes from
the constants below (10000-pose Manhattan world, partitioned Schur with
parts of at most 256 poses, lambda0 = 1e-5, 12 LM iterations, float32;
`--dtype float64` for the other) and prints:
  - the card's name and power limit;
  - it/s of five timed runs after a warm-up run (host clock around
    `torch.cuda.synchronize()`);
  - from one `torch.profiler` pass over one run: the device's busy share
    (device kernel time / wall time), the kernel count, and device time by
    operator;
  - the host-clock time of each phase of one iteration, each phase called
    alone between two synchronizes, mean of 10 calls.
With `--out FILE` the same text is also written to that file.
"""

import argparse
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.linear import schur
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam import manhattan

# the full-size pose-graph run, here and in chip_smoke.py phase 7: poses,
# largest part, lambda0 and LM iterations (bench.py's pose-graph metric)
POSE_N, POSE_PART, POSE_LAM0, POSE_ITERS = 10000, 256, 1e-5, 12
REPEATS = 10        # calls of each phase in the host-clock table
LINES = []


def say(text=""):
    print(text, flush=True)
    LINES.append(text)


def timed(fn, repeats):
    """(mean, min, max) host milliseconds of fn() between synchronizes."""
    fn()
    ms = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(ms)), min(ms), max(ms)


_CUDA = torch.autograd.DeviceType.CUDA
# the profiler's own bookkeeping, which it reports as device activity
_NOT_WORK = ("Buffer Flush", "Activity Buffer Request")


def device_ms(prof):
    """(total device ms, device event count, rows by operator) of a
    profile. The total sums the device-side events (kernels, copies, fills)
    once each; a row is an operator as the host called it, with the device
    time of the kernels it launched itself."""
    work = [e for e in prof.events()
            if e.device_type == _CUDA and e.name not in _NOT_WORK]
    total = sum(e.self_device_time_total for e in work) / 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != _CUDA and e.key not in _NOT_WORK
            and e.self_device_time_total > 0]
    return total, len(work), sorted(rows, key=lambda r: -r[1])


def device_ms_per_call(fn, n):
    """(device ms per call, device events per call) of fn(), from one
    profiler pass over n calls after 5 unrecorded ones."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, events, _ = device_ms(prof)
    return total / n, events / n


def profile_run(graph, initial, plan, lam0, iters):
    params = optimizers.Params(solver="schur")
    err0 = optimizers.graph_error(graph, initial)

    def run():
        return optimizers.lm_run(graph, initial, lam0, err0, iters, params,
                                 plan)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    say(f"warm-up run: {time.perf_counter() - t0:.3f} s")
    rates = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, lam, err = run()
        torch.cuda.synchronize()
        rates.append(iters / (time.perf_counter() - t0))
    say(f"{iters} iterations, five runs: "
        + ", ".join(f"{r:.3f}" for r in rates)
        + f" it/s; error {float(err0):.6g} -> {float(err):.6g}, lambda "
        f"{float(lam):g}")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    total, kernels, rows = device_ms(prof)
    say(f"profiled run of {iters} iterations: wall {wall:.2f} ms (with the "
        f"profiler on), device time {total:.2f} ms, busy share "
        f"{total / wall:.3f}, {kernels} device events")
    say("| Operator | Device ms | Share | Calls |")
    say("|---|---|---|---|")
    for key, ms, count in rows[:12]:
        say(f"| `{key}` | {ms:.3f} | {100 * ms / total:.1f}% | {count} |")
    rest = total - sum(r[1] for r in rows)
    say(f"| launched outside any operator | {rest:.3f} | "
        f"{100 * rest / total:.1f}% | |")


def profile_phases(graph, initial, plan, lam0, repeats):
    lam = torch.as_tensor(lam0, dtype=initial["se2"].dtype,
                          device=initial["se2"].device)
    lin = linearize(graph, initial)
    vals = schur.schur_values(lin, plan)
    fronts, rhs, ssys, srhs = schur.assemble(vals, plan)
    chol = schur.factor_interiors(fronts, plan, lam)
    y, W, sc, rhs_s = schur.eliminate_interiors(chol, fronts, rhs, plan)
    schur.extend_add(ssys, srhs, sc, rhs_s, plan)
    dsep = schur.solve_separator(ssys, srhs, plan, lam)
    delta = schur.back_substitute(y, W, dsep, plan)
    phases = [
        ("linearize (vmap + jacfwd, whitening)",
         lambda: linearize(graph, initial)),
        ("schur_values (block products)",
         lambda: schur.schur_values(lin, plan)),
        ("assembly scatter (4 index_add_)",
         lambda: schur.assemble(vals, plan)),
        ("batched interior Cholesky",
         lambda: schur.factor_interiors(fronts, plan, lam)),
        ("interior solves and Schur complements",
         lambda: schur.eliminate_interiors(chol, fronts, rhs, plan)),
        ("extend-add (8 buckets)",
         lambda: schur.extend_add(ssys.clone(), srhs.clone(), sc, rhs_s,
                                  plan)),
        ("separator Cholesky and solve",
         lambda: schur.solve_separator(ssys, srhs, plan, lam)),
        ("back-substitution and scatter",
         lambda: schur.back_substitute(y, W, dsep, plan)),
        ("solve_partitioned, whole",
         lambda: schur.solve_partitioned(lin, plan, lam)),
        ("retract", lambda: initial.retract(delta)),
        ("graph error", lambda: graph.error(initial)),
    ]
    say(f"| Phase | Host ms, mean of {repeats} | min | max |")
    say("|---|---|---|---|")
    for name, fn in phases:
        mean, lo, hi = timed(fn, repeats)
        say(f"| {name} | {mean:.3f} | {lo:.3f} | {hi:.3f} |")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float32")
    ap.add_argument("--out", help="also write the report to this file")
    args = ap.parse_args()
    dev = config.device("cuda")
    dtype = getattr(torch, args.dtype)
    say(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{POSE_N} poses, parts of at most {POSE_PART}, {args.dtype}, "
        f"lambda0 {POSE_LAM0:g}")
    graph, initial, _ = manhattan.make_manhattan(
        POSE_N, seed=42, device=dev, dtype=dtype)
    t0 = time.perf_counter()
    plan = schur.make_plan(graph, {"se2": POSE_N}, max_part_size=POSE_PART)
    say(f"{graph.num_factors} factors; plan {plan.stats()} built in "
        f"{time.perf_counter() - t0:.2f} s")
    profile_run(graph, initial, plan, POSE_LAM0, POSE_ITERS)
    profile_phases(graph, initial, plan, POSE_LAM0, REPEATS)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(LINES) + "\n")


if __name__ == "__main__":
    main()
