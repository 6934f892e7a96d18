"""Hybrid City10000: ambiguous loop closures as discrete-continuous inference.

    python -m gtsam_personal_tpu_torch.tools.hybrid_city10000 [FILE]
        [--max-lines 150] [--leaves 4] [--engine isam|smoother]
        [--device cuda]

JAX counterpart: examples/hybrid_city10000.py (the reference's
examples/Hybrid_City10000.cpp with City10000.h's parser), with the same
flags, parser and printed lines. Some edges of the T1_city10000 dataset
carry several candidate relative poses (data-association ambiguity); each
becomes a hybrid factor whose discrete mode selects the measurement.
`--engine isam` streams the edges through hybrid/hybrid.py:HybridISAM (one
ISAM2 engine per surviving hypothesis, `chain:se2` preconditioner),
`--engine smoother` through HybridSmoother (a batch re-solve of every
hypothesis at each hybrid factor). With no FILE the reference's example
data is looked up (slam/dataset.py:find_example_data:
T1_city10000_04.txt); any file of the parser's format works
(chip_smoke.py:write_city10000_hybrid writes a seeded stand-in). The
device is the card unless `--device cpu` asks for the CPU.

`run` does the work, prints through `say` and returns what it measured.
"""

import argparse
import time

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import FactorBatch, GraphBuilder
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.geometry import se2
from gtsam_personal_tpu_torch.hybrid.hybrid import (HybridFactor, HybridISAM,
                                                    HybridSmoother)
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2Params
from gtsam_personal_tpu_torch.slam import dataset, factors as F

SIGMAS = (0.05, 0.05, 0.02)


def parse_city10000_hybrid(path, max_lines):
    """Parse `EDGE2 keyS _ keyT _ numMeas x y rad [x y rad ...]` lines
    (reference: City10000.h parseLine)."""
    edges = []
    with open(path) as f:
        for ln, line in enumerate(f):
            if ln >= max_lines:
                break
            parts = line.split()
            if not parts or parts[0] != "EDGE2":
                continue
            ks, kt = int(parts[1]), int(parts[3])
            nm = int(parts[5])
            poses = [np.array([float(parts[6 + 3 * i]),
                               float(parts[7 + 3 * i]),
                               float(parts[8 + 3 * i])]) for i in range(nm)]
            edges.append((ks, kt, poses))
    return edges


def _compose(a, b):
    return se2.compose(torch.as_tensor(a, dtype=torch.float64),
                       torch.as_tensor(b, dtype=torch.float64)).numpy()


def run(path=None, max_lines=150, leaves=4, engine="isam", device="cuda",
        say=print):
    """Returns a dict: 'edges', 'poses', 'modes' (hybrid factors),
    'error', 'assignment', 'posterior', 'seconds' (the stream's wall time)
    and, for the isam engine, 'ms_per_edge'."""
    dev = config.device(device)
    if path is None:
        path = dataset.find_example_data("T1_city10000_04.txt")
    edges = parse_city10000_hybrid(path, max_lines)
    n = max(max(ks, kt) for ks, kt, _ in edges) + 1
    n_amb = sum(1 for _, _, p in edges if len(p) > 1)
    say(f"{len(edges)} edges over {n} poses ({n_amb} ambiguous)")
    rec = (run_isam if engine == "isam" else run_smoother)(
        edges, n, leaves, dev, say)
    rec.update(edges=len(edges), poses=n)
    return rec


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def run_isam(edges, n, leaves, dev, say=print):
    """Bounded-cost stream: one ISAM2 engine per surviving hypothesis
    (reference: Hybrid_City10000.cpp driving the hybrid smoother, here with
    per-update cost independent of history length)."""
    w = torch.as_tensor(1.0 / np.array(SIGMAS), device=dev)
    rb = F.make_between_residual("se2")
    pr = F.make_prior_residual("se2")
    hi = HybridISAM(
        max_leaves=leaves,
        params=ISAM2Params(relinearize_threshold=0.01, cg_maxiter=40,
                           cg_tol=1e-3, relin_chunk=256,
                           dtype=torch.float64, precond="chain:se2",
                           min_var_cap=n + 1, min_fac_cap=len(edges) + 8),
        device=dev)
    hi.add_variable("se2", np.zeros(3))
    hi.add_factor("prior_se2", pr, ["se2"], 3, [0], {"prior": np.zeros(3)},
                  NoiseModel("diag", torch.tensor([1e3, 1e3, 1e4],
                                                  device=dev)))
    hi.update()

    _sync(dev)
    t0 = time.time()
    added = 1
    t_seg, seg_n, seg_hyb = time.time(), 0, 0
    for ks, kt, poses in edges:
        if kt == added:
            best = hi.best_engine()
            hi.add_variable("se2", _compose(best.estimate_at("se2", ks),
                                            poses[0]))
            added += 1
        if len(poses) == 1:
            hi.add_factor("between_se2", rb, ["se2", "se2"], 3, [ks, kt],
                          {"measured": poses[0]}, NoiseModel("diag", w))
            hi.update()
        else:
            hi.add_hybrid_factor(
                "between_se2", rb, ["se2", "se2"], 3, [ks, kt],
                [{"measured": p} for p in poses], NoiseModel("diag", w),
                mode_var=1000 + seg_hyb)
            seg_hyb += 1
        seg_n += 1
        if added % 500 == 0 and seg_n > 400:
            say(f"  poses {added:5d}: {(time.time()-t_seg)/seg_n*1e3:7.2f} "
                f"ms/edge ({seg_hyb} modes so far)")
            t_seg, seg_n = time.time(), 0
    for _ in range(6):
        hi.update()
    _sync(dev)
    wall = time.time() - t0
    values, assignment, posterior = hi.estimate()
    err = hi.best_engine().error()
    say(f"\nhybrid-isam: {len(edges)} edges / {seg_hyb} discrete modes / "
        f"{leaves} leaves in {wall:.1f}s "
        f"({len(edges)/wall:.1f} edges/s)")
    say(f"final error {err:.4f}")
    say(f"mode assignment: {assignment}")
    top = sorted(posterior.items(), key=lambda kv: -kv[1])[:3]
    for a, wk in top:
        say(f"  P={wk:.3f}  modes={dict(a)}")
    return {"modes": seg_hyb, "error": err, "assignment": assignment,
            "posterior": posterior, "values": values, "seconds": wall,
            "ms_per_edge": wall / len(edges) * 1e3}


def run_smoother(edges, n, leaves, dev, say=print):
    """Batch re-solve of every surviving hypothesis at each hybrid factor
    (HybridSmoother), from the odometry-composed start."""
    init = np.zeros((n, 3))
    for ks, kt, poses in edges:
        if kt == ks + 1:
            init[kt] = _compose(init[ks], poses[0])
    initial = Values({"se2": torch.as_tensor(init, device=dev)})

    rb = F.make_between_residual("se2")
    w = torch.as_tensor(1.0 / np.array(SIGMAS), device=dev)[None]

    def between_batch(i, j, meas):
        # one residual function for every edge, so that the hypotheses'
        # graphs merge the one-edge batches into one (hybrid._merge_batches)
        return FactorBatch("between_se2", rb, ("se2", "se2"), 3,
                           torch.tensor([[i, j]], device=dev),
                           {"measured": torch.as_tensor(
                               np.asarray(meas)[None], device=dev)},
                           NoiseModel("diag", w))

    def make_hybrid(i, j, poses, var):
        base = between_batch(i, j, poses[0])
        meas = np.stack([np.asarray(p) for p in poses])[:, None]  # [m,1,3]
        return HybridFactor(
            FactorBatch(base.name, base.residual_fn, base.groups, 3,
                        base.idx, {"measured": torch.as_tensor(meas,
                                                               device=dev)},
                        base.noise),
            mode_var=var, num_modes=len(poses))

    prior = GraphBuilder()
    F.add_prior(prior, "se2", 0, np.zeros(3), F.diag_noise([1e-4] * 3))

    sm = HybridSmoother(max_leaves=leaves,
                        params=optimizers.Params(max_iterations=10))
    pending = list(prior.build(device=dev, dtype=torch.float64).batches)
    _sync(dev)
    t0 = time.time()
    nmodes = 0
    for ks, kt, poses in edges:
        if len(poses) == 1:
            pending.append(between_batch(ks, kt, poses[0]))
        else:
            sm.update(initial, continuous=pending,
                      hybrids=[make_hybrid(ks, kt, poses, 1000 + nmodes)])
            pending = []
            nmodes += 1
    if pending:
        sm.update(initial, continuous=pending)
    values, assignment, posterior = sm.estimate()
    _sync(dev)
    dt = time.time() - t0
    err = float(sm.graph.graph_at(assignment).error(values))
    say(f"smoother: {nmodes} discrete modes, final error {err:.4f}, "
        f"{dt:.1f}s ({dt / max(nmodes, 1):.2f}s/hybrid update)")
    say(f"mode assignment: {assignment}")
    top = sorted(posterior.items(), key=lambda kv: -kv[1])[:3]
    for a, w in top:
        say(f"  P={w:.3f}  modes={dict(a)}")
    return {"modes": nmodes, "error": err, "assignment": assignment,
            "posterior": posterior, "values": values, "seconds": dt}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default=None)
    ap.add_argument("--max-lines", type=int, default=150)
    ap.add_argument("--leaves", type=int, default=4)
    ap.add_argument("--engine", choices=["isam", "smoother"], default="isam",
                    help="isam: bounded-cost ISAM2 engine per hypothesis; "
                         "smoother: batch-resolve HybridSmoother")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run(a.path, a.max_lines, a.leaves, a.engine, a.device)


if __name__ == "__main__":
    main()
