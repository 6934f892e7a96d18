"""Manhattan-world SE(2) pose graph, the stand-in of city10000.

A frozen copy of gtsam_personal_tpu_torch/slam/manhattan.py:make_manhattan,
with the draws split between a structure seed and a noise seed
(gen/__init__.py) and the closure rule given two knobs. The trajectory is a
unit-step grid walk with 90-degree turns (probability `turn_prob`, biased
back toward the origin); every consecutive pair has an odometry edge; a pose
that revisits a grid cell gets a loop closure to each of up to
`max_closures_per_pose` earlier visits of that cell at least
`closure_min_gap` poses back. Measurements are the true relative poses plus
Gaussian noise (`trans_sigma` m, `rot_sigma` rad); the start composes the
noisy odometry from the true first pose.
"""

from typing import NamedTuple

import numpy as np


class PoseGraph(NamedTuple):
    ij: np.ndarray          # [K, 2] int64 edges (odometry first, then closures)
    measured: np.ndarray    # [K, 3] (x, y, theta) of pose i^-1 pose j
    sigmas: np.ndarray      # [3] noise of every edge
    prior: np.ndarray       # [3] prior on pose 0 (its true value)
    prior_sigmas: np.ndarray  # [3]
    start: np.ndarray       # [N, 3] composed from the odometry
    truth: np.ndarray       # [N, 3]


def _compose(a, b):
    """SE(2) a * b of [..., 3] arrays."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                     a[..., 1] + s * b[..., 0] + c * b[..., 1],
                     a[..., 2] + b[..., 2]], axis=-1)


def _between(a, b):
    """SE(2) a^-1 * b of [..., 3] arrays."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    inv = np.stack([-(c * a[..., 0] + s * a[..., 1]),
                    -(c * a[..., 1] - s * a[..., 0]), -a[..., 2]], axis=-1)
    return _compose(inv, b)


def structure(cfg):
    """(truth [N, 3], ij [K, 2]) from cfg["structure_seed"] alone."""
    a = cfg["assumed"]
    n = cfg["num_poses"]
    rng = np.random.default_rng(a["structure_seed"])
    truth = np.zeros((n, 3))
    heading = 0
    pos = np.zeros(2)
    dirs = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]])
    for i in range(1, n):
        if rng.random() < a["turn_prob"]:
            cand = [(heading + 1) % 4, (heading + 3) % 4]
            scores = [-(pos + dirs[c]) @ (pos + dirs[c]) for c in cand]
            heading = (cand[int(np.argmax(scores))] if rng.random() < 0.7
                       else cand[rng.integers(2)])
        pos = pos + dirs[heading]
        truth[i] = [pos[0], pos[1], heading * np.pi / 2]
    ij = [(i, i + 1) for i in range(n - 1)]
    cell = np.round(truth[:, :2]).astype(np.int64)
    seen = {}
    for i in range(n):
        prev = seen.setdefault((cell[i, 0], cell[i, 1]), [])
        added = 0
        for j in prev:
            if i - j >= a["closure_min_gap"] and \
                    added < a["max_closures_per_pose"]:
                ij.append((j, i))
                added += 1
        prev.append(i)
    return truth, np.array(ij, dtype=np.int64)


def make_graph(cfg, seed: int) -> PoseGraph:
    """The configuration's graph with noise drawn from `seed`."""
    a = cfg["assumed"]
    truth, ij = structure(cfg)
    sig = np.array([a["trans_sigma"], a["trans_sigma"], a["rot_sigma"]])
    rng = np.random.default_rng(seed)
    meas = _between(truth[ij[:, 0]], truth[ij[:, 1]]) + rng.normal(
        scale=sig, size=(len(ij), 3))
    meas[:, 2] = np.arctan2(np.sin(meas[:, 2]), np.cos(meas[:, 2]))
    n = truth.shape[0]
    # the start: the odometry (the first n - 1 edges) composed from pose 0
    odo = meas[:n - 1]
    theta = np.concatenate([[truth[0, 2]], truth[0, 2] + np.cumsum(odo[:, 2])])
    c, s = np.cos(theta[:-1]), np.sin(theta[:-1])
    step = np.stack([c * odo[:, 0] - s * odo[:, 1],
                     s * odo[:, 0] + c * odo[:, 1]], axis=1)
    xy = truth[0, :2] + np.concatenate([np.zeros((1, 2)),
                                        np.cumsum(step, axis=0)])
    start = np.concatenate([xy, theta[:, None]], axis=1)
    return PoseGraph(ij, meas, sig, truth[0].copy(),
                     np.array(a["prior_sigmas"], dtype=np.float64), start,
                     truth)
