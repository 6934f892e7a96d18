"""Solver comparison: the batch solvers against each other and against the
incremental engine on a pose-graph file, with snapshots and their diff.

    python -m gtsam_personal_tpu_torch.tools.solver_comparer [FILE] [--3d]
        [--n N] [--solvers dense,schur,pcg] [--incremental]
        [--snapshot OUT] [--compare A B] [--device cuda]

JAX counterpart: examples/solver_comparer.py (the reference's
examples/SolverComparer.cpp), with the same flags and the same printed
lines. Every batch solver ("dense", "schur", "pcg", "qr", "sequential";
optimize_lm, 50 iterations at most) must reach the same fixed point;
`--incremental` streams the file's measurements through ISAM2 and prints
its aligned ATE against the best batch result; `--snapshot` saves that
result (utils/serialization.py) and `--compare A B` diffs two snapshots.
With no FILE the reference's example data is looked up
(slam/dataset.py:find_example_data: w100.graph, or sphere2500.txt with
--3d); any g2o or TORO file of that shape works, e.g. one that
slam/dataset.py:write_g2o_2d writes. The device is the card unless
`--device cpu` asks for the CPU.

`run` does the work, prints through `say` and returns what it measured.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear import schur
from gtsam_personal_tpu_torch.linear.marginal import _select
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2, ISAM2Params
from gtsam_personal_tpu_torch.slam import (dataset, factors as F, initialize,
                                           metrics)
from gtsam_personal_tpu_torch.utils import serialization


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _truncate(graph, initial, group, n):
    """The first n poses and the factors among them."""
    batches = []
    for b in graph.batches:
        keep = (b.idx < n).all(dim=1).cpu().numpy()
        if keep.all():
            batches.append(b)
        elif keep.any():
            batches.append(_select(b, np.where(keep)[0]))
    return FactorGraph(batches), Values({group: initial[group][:n]})


def compare(path_a, path_b, say=print):
    """The `--compare` mode: {group: (max |diff|, rms)} of two snapshots."""
    va = serialization.load_values(path_a, device="cpu", dtype=None)
    vb = serialization.load_values(path_b, device="cpu", dtype=None)
    out = {}
    for g in va.groups():
        d = np.abs(va[g].numpy() - vb[g].numpy())
        out[g] = (float(d.max()), float(np.sqrt((d ** 2).mean())))
        say(f"{g}: max |diff| {out[g][0]:.3e}, rms {out[g][1]:.3e}")
    return out


def incremental(graph, initial, group, three_d, dev):
    """The file's between factors streamed into ISAM2, one update a
    measurement in the order of their later pose, then six more updates;
    returns (engine, seconds, measurements)."""
    n = initial[group].shape[0]
    between = [b for b in graph.batches if b.name == f"between_{group}"][0]
    ij = between.idx.cpu().numpy()
    meas = between.meas["measured"].cpu().numpy()
    S = (between.noise.data.cpu().numpy()
         if between.noise.data is not None else None)
    init = initial[group].cpu().numpy()
    dim = 6 if three_d else 3
    isam = ISAM2(ISAM2Params(relinearize_threshold=0.01, cg_maxiter=40,
                             cg_tol=1e-3, dtype=torch.float64,
                             precond=f"chain:{group}", min_var_cap=n + 1,
                             min_fac_cap=len(ij) + 8), device=dev)
    rb = F.make_between_residual(group)
    isam.add_variable(group, init[0])
    isam.add_factor(f"prior_{group}", F.make_prior_residual(group), [group],
                    dim, [0], {"prior": init[0]},
                    NoiseModel("diag", np.full((dim,), 1e3)))
    isam.update()
    added = 1
    t0 = time.perf_counter()
    for k in np.argsort(ij.max(axis=1), kind="stable"):
        i, j = int(ij[k, 0]), int(ij[k, 1])
        while added <= max(i, j):
            isam.add_variable(group, init[added])
            added += 1
        nm = (NoiseModel("full", S[k]) if S is not None
              else NoiseModel("unit"))
        isam.add_factor(f"between_{group}", rb, [group, group], dim, [i, j],
                        {"measured": meas[k]}, nm)
        isam.update()
    for _ in range(6):
        isam.update()
    _sync(dev)
    return isam, time.perf_counter() - t0, len(ij)


def run(path=None, three_d=False, n=None, solvers="dense,schur,pcg",
        with_incremental=False, snapshot=None, device="cuda", say=print):
    """The tool's batch and incremental modes; returns {"results": {solver:
    Result}, "seconds": {solver: s}, "best": solver, "diffs": {solver: max
    parameter difference to the first}, and with `with_incremental` the
    engine's "incremental_error" and "incremental_ate"}."""
    dev = config.device(device)
    if path is None:
        path = dataset.find_example_data(
            "sphere2500.txt" if three_d else "w100.graph")
    group = "se3" if three_d else "se2"
    load = dataset.load_3d if three_d else dataset.load_2d
    graph, initial = load(path, device=dev, dtype=torch.float64)
    total = initial[group].shape[0]
    if n and n < total:
        graph, initial = _truncate(graph, initial, group, n)
    n = initial[group].shape[0]
    say(f"{n} poses, {graph.num_factors} factors")
    if three_d:
        initial = initialize.chordal_init_f64(graph, n, device=dev,
                                              dtype=torch.float64)
    e0 = float(optimizers.graph_error(graph, initial))
    say(f"initial error: {e0:.6g}")

    rec = {"results": {}, "seconds": {}, "diffs": {}}
    for solver in solvers.split(","):
        solver = solver.strip()
        params = optimizers.Params(solver=solver, max_iterations=50)
        plan = (schur.make_plan(graph, initial.counts(), max_part_size=128)
                if solver == "schur" else None)
        _sync(dev)
        t0 = time.perf_counter()
        res = optimizers.optimize_lm(graph, initial, params, plan=plan)
        _sync(dev)
        wall = time.perf_counter() - t0
        rec["results"][solver], rec["seconds"][solver] = res, wall
        say(f"  {solver:8s}: error {float(res.error):.6g} in "
            f"{res.iterations} iters, {wall:.2f}s")

    # cross-solver agreement (SolverComparer's --compare role, in-process)
    names = list(rec["results"])
    ref = rec["results"][names[0]].values[group]
    for nm in names[1:]:
        d = float((rec["results"][nm].values[group] - ref).abs().max())
        rec["diffs"][nm] = d
        say(f"  |{names[0]} - {nm}| max param diff: {d:.3e}")
    rec["best"] = min(names, key=lambda s: float(rec["results"][s].error))
    best = rec["results"][rec["best"]]

    if with_incremental:
        isam, wall, n_meas = incremental(graph, initial, group, three_d, dev)
        err = isam.error()
        say(f"  incremental: error {err:.6g}, {n_meas / wall:.1f} factors/s"
            f" ({wall:.1f}s)")
        est = isam.estimate_array(group)[:n]
        ref = best.values[group].cpu().numpy()
        if three_d:
            stats = metrics.ate(est[:, :, 3], ref[:, :, 3], align=True)
        else:
            stats = metrics.ate(est[:, :2], ref[:, :2], align=True)
        say(f"  incremental vs batch ATE: {stats['rmse']:.4f}")
        rec["incremental_error"], rec["incremental_ate"] = err, stats["rmse"]

    if snapshot:
        serialization.save_values(snapshot, best.values)
        say(f"snapshot -> {snapshot}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--3d", dest="three_d", action="store_true")
    ap.add_argument("--n", type=int, default=None, help="pose cap")
    ap.add_argument("--solvers", default="dense,schur,pcg")
    ap.add_argument("--incremental", action="store_true")
    ap.add_argument("--snapshot", default=None,
                    help="save the best batch solution's values")
    ap.add_argument("--compare", nargs=2, default=None,
                    help="diff two snapshot files and exit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return
    run(args.path, args.three_d, args.n, args.solvers, args.incremental,
        args.snapshot, args.device)


if __name__ == "__main__":
    main()
