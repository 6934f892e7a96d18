"""Pose-graph SLAM from a g2o / TORO file, 2D and 3D.

    python -m gtsam_personal_tpu_torch.tools.pose_graph_g2o FILE [--3d]
        [--out result.g2o] [--fmt quat|edge3] [--max-part 128]
        [--dtype float32|float64] [--device cuda]

JAX counterpart: examples/pose_graph_g2o.py (the reference's
Pose2SLAMExample_g2o.cpp and Pose3SLAMExample_initializePose3.cpp): load the
file, for 3D take the chordal initialization (on the host in float64,
whatever the compute dtype), run batch LM with the partitioned-Schur solver
(30 iterations at most), write the result. The device is the card unless
`--device cpu` asks for the CPU; with no card `--device cuda` raises
(config.device). With no FILE the example data of the reference is looked
up (slam/dataset.py:find_example_data).

`run` does the work, prints through `say` and returns what it measured.
"""

import argparse
import time

import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.linear import schur
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam import dataset, initialize

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run(path, three_d=False, out=None, fmt="quat", max_part=128,
        dtype="float64", device="cuda", say=print):
    """The tool's steps; returns a dict of what it measured: seconds per
    step ('load', 'init', 'plan', 'lm', 'write'), the errors ('initial',
    'init', 'final'), LM iterations, and the Result."""
    dev = config.device(device)
    dt = DTYPES[dtype]
    rec = {"seconds": {}}

    def step(name, t0):
        _sync(dev)
        rec["seconds"][name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if three_d:
        graph, initial = dataset.load_3d(path, device=dev, dtype=dt)
        group = "se3"
    else:
        graph, initial = dataset.load_2d(path, device=dev, dtype=dt)
        group = "se2"
    step("load", t0)
    n = initial[group].shape[0]
    rec["initial"] = float(optimizers.graph_error(graph, initial))
    say(f"loaded {n} poses, {graph.num_factors} factors "
        f"({rec['seconds']['load']:.2f}s)")
    if three_d:
        say(f"odometry error: {rec['initial']}")
        t0 = time.perf_counter()
        # float64 on the host whatever the compute dtype: the float32
        # chordal point lands LM in a worse basin (PERFORMANCE.md, round 3)
        initial = initialize.chordal_init_f64(graph, n, device=dev, dtype=dt)
        step("init", t0)
        rec["init"] = float(optimizers.graph_error(graph, initial))
        say(f"chordal-init error: {rec['init']} "
            f"({rec['seconds']['init']:.2f}s)")
    else:
        say(f"initial error: {rec['initial']}")

    t0 = time.perf_counter()
    plan = schur.make_plan(graph, initial.counts(), max_part_size=max_part)
    step("plan", t0)
    say(f"partition: {plan.stats()} ({rec['seconds']['plan']:.2f}s)")

    t0 = time.perf_counter()
    res = optimizers.optimize_lm(
        graph, initial, optimizers.Params(solver="schur", max_iterations=30),
        plan=plan)
    step("lm", t0)
    rec.update(final=res.error, iterations=res.iterations, result=res)
    say(f"final error: {res.error:.6g} in {res.iterations} iterations "
        f"({rec['seconds']['lm']:.2f}s), converged={res.converged}")

    if out:
        t0 = time.perf_counter()
        if three_d:
            dataset.write_g2o_3d(out, res.values, graph, fmt=fmt)
        else:
            dataset.write_g2o_2d(out, res.values, graph)
        rec["seconds"]["write"] = time.perf_counter() - t0
        say(f"wrote {out}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--3d", dest="three_d", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--max-part", type=int, default=128)
    ap.add_argument("--fmt", default="quat", choices=["quat", "edge3"],
                    help="3D output format: EDGE_SE3:QUAT or EDGE3")
    ap.add_argument("--dtype", default="float64", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.path is None:
        args.path = dataset.find_example_data(
            "sphere2500.txt" if args.three_d else "w100.graph")
    run(args.path, args.three_d, args.out, args.fmt, args.max_part,
        args.dtype, args.device)


if __name__ == "__main__":
    main()
