"""BAL-shaped bundle adjustment problem with skewed tracks and cameras.

A frozen copy of gtsam_personal_tpu_torch/sfm/synthetic.py:
make_skewed_problem, vectorised, with the draws split between a structure
seed and a noise seed (gen/__init__.py). Cameras stand on a ring of
`radius` looking at its centre (a Ladybug-like sequential capture); track
lengths follow 2 + Zipf(`track_zipf`) capped at `max_track` and scaled to
`mean_track`; a track starts at a camera drawn from a Zipf(`cam_zipf`)
popularity over a random permutation of the cameras and covers consecutive
cameras. Measurements are exact Cal3Bundler projections plus `noise_px`
Gaussian pixels; the start perturbs camera centres and points by
`init_noise`.
"""

from typing import NamedTuple

import numpy as np


class BAProblem(NamedTuple):
    cam_poses: np.ndarray     # [C, 3, 4] camera-to-world, the start
    cam_cals: np.ndarray      # [C, 3] (f, k1, k2)
    points: np.ndarray        # [P, 3] the start
    obs_cam: np.ndarray       # [M] int64
    obs_point: np.ndarray     # [M] int64
    obs_uv: np.ndarray        # [M, 2]


def structure(cfg):
    """(obs_cam [M], obs_point [M], poses_true [C, 3, 4], points_true [P, 3])
    from cfg["structure_seed"] alone."""
    a = cfg["assumed"]
    C, P = cfg["num_cameras"], cfg["num_points"]
    rng = np.random.default_rng(a["structure_seed"])
    raw = rng.zipf(a["track_zipf"], size=P).astype(np.int64) + 1
    lengths = np.clip(raw, 2, a["max_track"])
    scale = a["mean_track"] / lengths.mean()
    lengths = np.clip((lengths * scale).astype(np.int64), 2, a["max_track"])
    pop = 1.0 / np.arange(1, C + 1) ** a["cam_zipf"]
    pop = pop[rng.permutation(C)]
    pop /= pop.sum()
    starts = rng.choice(C, size=P, p=pop)
    M = int(lengths.sum())
    first = np.repeat(np.cumsum(lengths) - lengths, lengths)
    obs_cam = (np.repeat(starts, lengths) + np.arange(M) - first) % C
    obs_point = np.repeat(np.arange(P, dtype=np.int64), lengths)

    angles = np.linspace(0, 2 * np.pi, C, endpoint=False)
    r = a["radius"]
    centers = np.stack([r * np.cos(angles), r * np.sin(angles),
                        rng.normal(scale=0.5, size=C)], axis=1)
    z = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    x = np.cross(np.array([0.0, 0.0, 1.0]), z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    poses = np.concatenate([np.stack([x, y, z], axis=2),
                            centers[:, :, None]], axis=2)
    points = rng.normal(scale=2.0, size=(P, 3))
    # every observation in front of its camera (depth > 0.1), as the
    # original's filter keeps them
    pc = np.einsum("mji,mj->mi", poses[obs_cam, :, :3],
                   points[obs_point] - poses[obs_cam, :, 3])
    keep = pc[:, 2] > 0.1
    return obs_cam[keep], obs_point[keep], poses, points


def make_problem(cfg, seed: int) -> BAProblem:
    """The configuration's problem with noise and start drawn from `seed`."""
    a = cfg["assumed"]
    obs_cam, obs_point, poses, points = structure(cfg)
    C = poses.shape[0]
    f = a["focal"]
    cals = np.tile(np.array([f, 1e-8, 1e-8]), (C, 1))
    pc = np.einsum("mji,mj->mi", poses[obs_cam, :, :3],
                   points[obs_point] - poses[obs_cam, :, 3])
    pn = pc[:, :2] / pc[:, 2:3]
    r2 = np.sum(pn * pn, axis=1)
    k1, k2 = cals[obs_cam, 1], cals[obs_cam, 2]
    g = f * (1 + k1 * r2 + k2 * r2 * r2)
    rng = np.random.default_rng(seed)
    uv = g[:, None] * pn + rng.normal(scale=a["noise_px"],
                                      size=(len(obs_cam), 2))
    start = poses.copy()
    start[:, :, 3] += rng.normal(scale=a["init_noise"], size=(C, 3))
    pts = points + rng.normal(scale=a["init_noise"], size=points.shape)
    return BAProblem(start, cals, pts, obs_cam.astype(np.int64),
                     obs_point.astype(np.int64), uv)
