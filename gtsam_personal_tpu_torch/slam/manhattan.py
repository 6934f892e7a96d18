"""Manhattan-world pose-graph generator (M3500 shape).

JAX counterpart: gtsam_personal_tpu/slam/manhattan.py (all of it). The
classic Olson M3500 benchmark (3500 poses on a city grid, ~5600 constraints)
is not shipped with the reference's data; this generator reproduces its
statistics: unit grid steps with 90-degree turns, odometry between every
consecutive pair, and proximity loop closures between revisit pairs.

The same arguments give the JAX generator's graph: the `rng` calls come in
the same order (`random`, `integers`, `normal(scale=[...])`), so the index
arrays are equal and the measurements agree to the last bits of cos and sin.
The JAX generator composes poses through its SE(2) functions one pose at a
time; here that is numpy on the host, and only the finished arrays go to the
device.
"""

from typing import Tuple

import numpy as np

from gtsam_personal_tpu_torch.core.graph import FactorGraph, GraphBuilder
from gtsam_personal_tpu_torch.core.values import Values, values_from_numpy
from gtsam_personal_tpu_torch.slam import factors as F


def _compose_np(a, b):
    """SE(2) a * b for (x, y, theta) triples, as geometry/se2.py:compose."""
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     a[2] + b[2]])


def _between_np(a, b):
    """SE(2) a^{-1} * b, as geometry/se2.py:between."""
    c, s = np.cos(a[2]), np.sin(a[2])
    inv = np.array([-(c * a[0] + s * a[1]), -(c * a[1] - s * a[0]), -a[2]])
    return _compose_np(inv, b)


def make_manhattan(n_poses: int = 3500, seed: int = 42,
                   turn_prob: float = 0.25, closure_radius: float = 1.5,
                   max_closures_per_pose: int = 1,
                   trans_sigma: float = 0.05, rot_sigma: float = 0.01,
                   init_from_odometry: bool = True, *, device,
                   dtype) -> Tuple[FactorGraph, Values, np.ndarray]:
    """Returns (graph, initial, truth[n, 3]), graph and initial on `device`
    in `dtype`. Odometry chain + loop closures; the initial estimate is
    composed from the noisy odometry (the hard, realistic start: drift grows
    with path length)."""
    rng = np.random.default_rng(seed)

    # ground-truth trajectory: a grid walk with 90-degree turns, biased to
    # stay near the origin (city-block revisits generate closures)
    truth = np.zeros((n_poses, 3))
    heading = 0
    pos = np.zeros(2)
    dirs = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    for i in range(1, n_poses):
        if rng.random() < turn_prob:
            # prefer turning back toward the origin to keep the map compact
            cand = [(heading + 1) % 4, (heading + 3) % 4]
            scores = [-(pos + dirs[c]) @ (pos + dirs[c]) for c in cand]
            heading = cand[int(np.argmax(scores))] \
                if rng.random() < 0.7 else cand[rng.integers(2)]
        pos = pos + dirs[heading]
        truth[i] = [pos[0], pos[1], heading * np.pi / 2]

    def noisy_between(a, b):
        rel = _between_np(a, b)
        rel = rel + rng.normal(scale=[trans_sigma, trans_sigma, rot_sigma])
        rel[2] = np.arctan2(np.sin(rel[2]), np.cos(rel[2]))
        return rel

    # odometry measurements
    b = GraphBuilder()
    F.add_prior(b, "se2", 0, truth[0], F.diag_noise([0.1, 0.1, 0.05]))
    odo_noise = F.diag_noise([trans_sigma, trans_sigma, rot_sigma])
    meas = np.zeros((n_poses - 1, 3))
    for i in range(n_poses - 1):
        meas[i] = noisy_between(truth[i], truth[i + 1])
        F.add_between(b, "se2", i, i + 1, meas[i], odo_noise)

    # loop closures: revisited grid cells within closure_radius
    cell = np.round(truth[:, :2]).astype(np.int64)
    seen = {}
    for i in range(n_poses):
        prev = seen.setdefault((cell[i, 0], cell[i, 1]), [])
        added = 0
        for j in prev:
            if i - j > 50 and added < max_closures_per_pose:
                d = np.linalg.norm(truth[i, :2] - truth[j, :2])
                if d <= closure_radius:
                    F.add_between(b, "se2", int(j), int(i),
                                  noisy_between(truth[j], truth[i]),
                                  odo_noise)
                    added += 1
        prev.append(i)

    graph = b.build(device=device, dtype=dtype)

    if init_from_odometry:
        init = np.zeros((n_poses, 3))
        init[0] = truth[0]
        for i in range(n_poses - 1):
            init[i + 1] = _compose_np(init[i], meas[i])
    else:
        init = truth + rng.normal(scale=0.1, size=truth.shape)
    return graph, values_from_numpy({"se2": init}, device=device,
                                    dtype=dtype), truth
