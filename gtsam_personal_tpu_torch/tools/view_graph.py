"""View-graph calibration-free SfM: fundamental matrices estimated directly
from point correspondences with transfer factors.

    python -m gtsam_personal_tpu_torch.tools.view_graph [--device cuda]

JAX counterpart: examples/view_graph.py (the reference's
examples/ViewGraphExample.cpp), with the same printed lines: 4 poses on a
circle observe the 8 cube corners; the 8 unknown fundamental matrices
(edges one and two poses apart, cyclic) are estimated from 96
TransferFactors that chain epipolar transfer across view triplets, LM
from the truth perturbed by [1..7] * 1e-5 (ViewGraphExample.cpp:104).
The device is the card unless `--device cpu` asks for the CPU; float64.

OK means: a final error below 1e-10 and every normalized F within 1e-4 of
the truth.
"""

import argparse

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.geometry import cameras, fundamental, se3, so3
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.slam.factors import transfer_factor_residual
from gtsam_personal_tpu_torch.tools.visual_isam2 import CAL, make_scene

K = np.array([[50.0, 0, 50], [0, 50, 50], [0, 0, 1.0]])
# the 8 unknown edges: one apart and two apart, cyclic (reference: 8
# unique EdgeKeys)
EDGES = [(a, (a + 1) % 4) for a in range(4)] + \
        [(a, (a + 2) % 4) for a in range(4)]


def truth_and_pixels():
    """(the 8 true F [8, 3, 3] with x_a^T F x_b = 0, pixels [4, 8, 2])."""
    poses, pts = make_scene(4, 8)
    P = torch.tensor(poses)
    aTb = se3.between(P[[a for a, _ in EDGES]],
                      P[[b for _, b in EDGES]]).numpy()
    t = aTb[:, :, 3] / np.linalg.norm(aTb[:, :, 3], axis=1, keepdims=True)
    E = so3.hat(torch.tensor(t)).numpy() @ aTb[:, :, :3]
    Ki = np.linalg.inv(K)
    F = Ki.T @ E @ Ki
    pix = cameras.project_point(P[:, None], torch.tensor(pts)[None],
                                torch.tensor(CAL)).numpy()
    return F, pix


def run(device="cuda", dtype=torch.float64, say=print):
    """Returns a dict: the LM 'result', 'errors' (normalized |F - F_gt| a
    edge), 'worst' and 'ok'."""
    dev = config.device(device)
    truth, pix = truth_and_pixels()
    eix = {e: i for i, e in enumerate(EDGES)}
    gb = GraphBuilder()
    npts = pix.shape[1]
    noise = {"kind": "diag", "data": np.full(2, 1.0)}
    for a in range(4):
        bb, c = (a + 1) % 4, (a + 2) % 4
        for j in range(npts):
            pa, pb, pc = pix[a, j], pix[bb, j], pix[c, j]
            # (edges, pixels into the transfer, the transpose flags): c
            # from a and b through F(c,a), F(c,b), the transposes of the
            # stored (a,c), (b,c); b from a and c; a from b and c
            for edges, (p1, p2, p3), flags in (
                    (((a, c), (bb, c)), (pa, pb, pc), (True, True)),
                    (((a, bb), (bb, c)), (pa, pc, pb), (True, False)),
                    (((a, bb), (a, c)), (pb, pc, pa), (False, False))):
                gb.add("transfer", transfer_factor_residual,
                       ("fundamental", "fundamental"), 2,
                       [eix[edges[0]], eix[edges[1]]],
                       {"pa": p1, "pb": p2, "pc": p3,
                        "transpose1": np.asarray(flags[0]),
                        "transpose2": np.asarray(flags[1])}, noise)
    graph = gb.build(device=dev, dtype=dtype)
    # perturbed truth, as the reference: the transfer cost is sharply
    # nonconvex in F-space, so refinement starts near a good estimate
    m = manifolds.get("fundamental")
    T = torch.tensor
    init = np.stack([m.retract(fundamental.fundamental_from_matrix(T(F)),
                               T(np.arange(1, 8) * 1e-5)).numpy()
                     for F in truth])
    res = optimizers.optimize_lm(
        graph, values_from_numpy({"fundamental": init}, device=dev,
                                 dtype=dtype),
        optimizers.Params(max_iterations=50))
    got = fundamental.fundamental_matrix(
        res.values["fundamental"]).cpu().numpy()
    say(f"8 fundamental matrices from {3 * 4 * npts} transfer factors: "
        f"final error {res.error:.3e} in {res.iterations} iterations")
    errors = []
    for e, M, F_gt in zip(EDGES, got, truth):
        Mn, Gn = M / np.linalg.norm(M), F_gt / np.linalg.norm(F_gt)
        if np.sum(Mn * Gn) < 0:
            Mn = -Mn
        errors.append(np.abs(Mn - Gn).max())
        say(f"  edge {e}: |F - F_gt| (normalized) = {errors[-1]:.2e}")
    worst = max(errors)
    ok = bool(res.error < 1e-10 and worst < 1e-4)
    say("VIEW-GRAPH OK" if ok else "VIEW-GRAPH FAIL")
    return {"result": res, "errors": errors, "worst": worst, "ok": ok}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return 0 if run(ap.parse_args(argv).device)["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
