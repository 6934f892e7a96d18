"""Pose2SLAMExample: a 5-pose 2D pose graph with a loop closure.

    python -m gtsam_personal_tpu_torch.tools.pose2_slam_example
        [--device cuda]

JAX counterpart: examples/pose2_slam_example.py (the reference's
examples/Pose2SLAMExample.cpp:66): a prior on the first pose, odometry, one
loop closure; Gauss-Newton converges to the exact square, and the
marginal covariances of the poses are printed. The device is the card
unless `--device cpu` asks for the CPU.
"""

import argparse

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import GraphBuilder
from gtsam_personal_tpu_torch.core.values import values_from_numpy
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.marginals import Marginals
from gtsam_personal_tpu_torch.slam import factors as F

INITIAL = np.array([[0.5, 0.0, 0.2], [2.3, 0.1, -0.2],
                    [4.1, 0.1, np.pi / 2], [4.0, 2.0, np.pi],
                    [2.1, 2.1, -np.pi / 2]])


def build(device="cuda"):
    """(graph, initial values) of the example on `device`, in float64."""
    dev = config.device(device)
    builder = GraphBuilder()
    F.add_prior(builder, "se2", 0, np.zeros(3),
                F.diag_noise([0.3, 0.3, 0.1]))
    odo_noise = F.diag_noise([0.2, 0.2, 0.1])
    F.add_between(builder, "se2", 0, 1, np.array([2.0, 0.0, 0.0]), odo_noise)
    for i in (1, 2, 3):
        F.add_between(builder, "se2", i, i + 1,
                      np.array([2.0, 0.0, np.pi / 2]), odo_noise)
    F.add_between(builder, "se2", 4, 1, np.array([2.0, 0.0, np.pi / 2]),
                  odo_noise)
    return (builder.build(device=dev, dtype=torch.float64),
            values_from_numpy({"se2": INITIAL}, device=dev,
                              dtype=torch.float64))


def run(device="cuda", say=print):
    """Returns a dict: 'initial' error, the GN 'result', 'cov' [5, 3, 3]
    (numpy)."""
    graph, initial = build(device)
    rec = {"initial": float(optimizers.graph_error(graph, initial))}
    say(f"initial error: {rec['initial']}")
    result = optimizers.optimize_gn(graph, initial)
    rec["result"] = result
    say(f"final error:   {result.error} ({result.iterations} iterations)")
    say(f"optimized poses:\n {result.values['se2'].cpu().numpy()}")

    marginals = Marginals(graph, result.values)
    rec["cov"] = np.stack([marginals.marginal_covariance("se2", i)
                           .cpu().numpy() for i in range(5)])
    for i in range(5):
        say(f"P(x{i}) cov diag: {np.diag(rec['cov'][i])}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
