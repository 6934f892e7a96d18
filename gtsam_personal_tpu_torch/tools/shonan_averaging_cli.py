"""Shonan rotation averaging of a 3D pose-graph file.

    python -m gtsam_personal_tpu_torch.tools.shonan_averaging_cli [FILE]
        [--pmin 3] [--pmax 7] [--start reference|chordal]
        [--dtype float64|float32] [--device cuda]

JAX counterpart: examples/shonan_averaging_cli.py (the reference's
examples/ShonanAveragingCLI.cpp): read the relative rotations of a g2o /
TORO 3D file (slam/dataset.py:load_3d), run the certifiable staircase
(sfm/shonan.py:shonan_averaging) and print the same two lines as the JAX
example: the rotation and measurement counts, then `certified`, `p`,
`min_eig` and the cost. The start is the JAX example's
(`--start reference`, sfm/shonan.py:_chordal_rotations, which changes from
call to call) unless `--start chordal` asks for sfm/shonan.py:
chordal_start, the same chordal start without the reference's two faults
(ROADMAP queue 3 C11). Seconds per level (LM iterations, PCG iterations
per LM iteration, the power method's seconds) go to stderr. The device is
the card unless `--device cpu` asks for the CPU. With no FILE it looks for
pose3example.txt as tools/pose_graph_g2o.py does
(slam/dataset.py:find_example_data).

`run` does the work, prints through `say` and `note` and returns what it
measured.
"""

import argparse
import contextlib
import sys
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.linear import solvers
from gtsam_personal_tpu_torch.sfm import shonan
from gtsam_personal_tpu_torch.slam import dataset

DTYPES = {"float32": torch.float32, "float64": torch.float64}


@contextlib.contextmanager
def count_pcg_iterations():
    """Collects the iteration count of every PCG solve made inside the
    block into the list it yields (one host read per solve)."""
    counts = []
    inner = solvers.pcg_loop

    def counting(*args, **kwargs):
        x, used = inner(*args, **kwargs)
        counts.append(int(used))
        return x, used

    solvers.pcg_loop = counting
    try:
        yield counts
    finally:
        solvers.pcg_loop = inner


def read_rotations(path):
    """(edges [K, 2] int64, relative rotations [K, 3, 3], pose count) of a
    3D pose-graph file, in numpy."""
    graph, initial = dataset.load_3d(path, device="cpu", dtype=torch.float64)
    b = [x for x in graph.batches if x.name == "between_se3"][0]
    return (b.idx.numpy(), b.meas["measured"][:, :, :3].numpy(),
            initial["se3"].shape[0])


STARTS = {"reference": shonan._chordal_rotations,
          "chordal": shonan.chordal_start}


def run(path, p_min=3, p_max=7, dtype="float64", device="cuda", v0=None,
        seed=0, start="reference", say=print, note=None):
    """The tool's steps; returns a dict: 'n', 'edges', 'R_meas', 'chordal'
    (the start, [n, 3, 3]) and its seconds 'chordal_s', 'result'
    (ShonanResult), 'levels' (per level: p, lm_s, lm_iterations, error,
    pcg (the iterations of each PCG solve of the level), eig_s, min_eig),
    and 'seconds' (the whole staircase, chordal start included)."""
    if note is None:
        note = lambda s: print(s, file=sys.stderr)
    dev = config.device(device)
    edges, R_meas, n = read_rotations(path)
    say(f"{n} rotations, {len(edges)} measurements")
    rec = {"n": n, "edges": edges, "R_meas": R_meas, "levels": []}
    t0 = time.perf_counter()
    rec["chordal"] = STARTS[start](edges, R_meas, n)
    rec["chordal_s"] = time.perf_counter() - t0
    note(f"{start} start (host): {rec['chordal_s']:.3f} s")

    with count_pcg_iterations() as pcg:
        def on_level(lv):
            res = lv["result"]
            used = list(pcg)
            pcg.clear()
            rec["levels"].append({
                "p": lv["p"], "lm_s": lv["lm_s"],
                "lm_iterations": res.iterations, "error": res.error,
                "pcg": used, "eig_s": lv["eig_s"], "min_eig": lv["min_eig"]})
            note(f"p={lv['p']}: LM {lv['lm_s']:.3f} s, {res.iterations} "
                 f"iterations, {len(used)} PCG solves, "
                 f"{np.mean(used) if used else 0.0:.1f} PCG iterations a "
                 f"solve (max {max(used, default=0)}), error "
                 f"{res.error:.6g}; min_eigenvalue {lv['eig_s']:.3f} s: "
                 f"{lv['min_eig']:.3e}")

        res = shonan.shonan_averaging(
            edges, R_meas, p_min=p_min, p_max=p_max, init=rec["chordal"],
            seed=seed, v0=v0, device=dev, dtype=DTYPES[dtype],
            on_level=on_level)
    rec["seconds"] = time.perf_counter() - t0
    rec["result"] = res
    note(f"staircase: {rec['seconds']:.3f} s")
    say(f"certified={res.certified} at p={res.p_final}, "
        f"min_eig={res.min_eig:.2e}, cost={res.cost:.6g}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--pmin", type=int, default=3)
    ap.add_argument("--pmax", type=int, default=7)
    ap.add_argument("--start", default="reference", choices=sorted(STARTS))
    ap.add_argument("--dtype", default="float64", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.path is None:
        args.path = dataset.find_example_data("pose3example.txt")
    run(args.path, args.pmin, args.pmax, args.dtype, args.device,
        start=args.start)


if __name__ == "__main__":
    main()
