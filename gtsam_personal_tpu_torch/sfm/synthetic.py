"""Synthetic SfM problem generator (BAL-shaped), in numpy.

JAX counterpart: gtsam_personal_tpu/sfm/synthetic.py:make_ring_problem,
make_skewed_problem. The RNG call sequence is the JAX module's, call for
call, so one seed gives bit-identical arrays in both packages.

Mirrors the scale/shape of the BAL suite (e.g. Ladybug-1723: 1723 cameras,
~156k points, ~678k observations). Cameras on a ring looking inward at a
point cloud; exact measurements optionally perturbed, initial state perturbed.
"""

import numpy as np

from gtsam_personal_tpu_torch.sfm.bal import BalProblem


def make_ring_problem(num_cameras=50, num_points=500, obs_per_point=6,
                      noise_px=1.0, init_noise=0.05, seed=0,
                      radius=10.0, focal=800.0):
    rng = np.random.default_rng(seed)
    C, P = num_cameras, num_points

    # ground-truth cameras: ring of radius `radius`, looking at the origin
    angles = np.linspace(0, 2 * np.pi, C, endpoint=False)
    centers = np.stack([radius * np.cos(angles), radius * np.sin(angles),
                        rng.normal(scale=0.5, size=C)], axis=1)
    # camera-to-world rotation: z-axis points from center toward origin
    z = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 0.0, 1.0]), (C, 1))
    x = np.cross(up, z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    wRc = np.stack([x, y, z], axis=2)  # columns are camera axes in world
    poses = np.concatenate([wRc, centers[:, :, None]], axis=2)

    points = rng.normal(scale=2.0, size=(P, 3))
    cals = np.tile(np.array([focal, 1e-8, 1e-8]), (C, 1))

    # observations: each point seen by a run of consecutive cameras
    obs_cam, obs_point = [], []
    start = rng.integers(0, C, size=P)
    for j in range(P):
        for t in range(obs_per_point):
            obs_cam.append((start[j] + t) % C)
            obs_point.append(j)
    obs_cam = np.array(obs_cam, dtype=np.int32)
    obs_point = np.array(obs_point, dtype=np.int32)

    # exact projections (GTSAM convention, Cal3Bundler)
    Rw = poses[obs_cam, :, :3]
    tw = poses[obs_cam, :, 3]
    pc = np.einsum("mji,mj->mi", Rw, points[obs_point] - tw)  # R^T (X - t)
    z_safe = np.where(np.abs(pc[:, 2]) < 1e-6, 1e-6, pc[:, 2])
    pn = pc[:, :2] / z_safe[:, None]
    r2 = np.sum(pn * pn, axis=1)
    f, k1, k2 = cals[obs_cam, 0], cals[obs_cam, 1], cals[obs_cam, 2]
    g = f * (1 + k1 * r2 + k2 * r2 * r2)
    uv = g[:, None] * pn + rng.normal(scale=noise_px, size=(len(obs_cam), 2))

    # keep only in-front observations
    keep = pc[:, 2] > 0.1
    obs_cam, obs_point, uv = obs_cam[keep], obs_point[keep], uv[keep]

    # perturb initial state
    poses_init = poses.copy()
    poses_init[:, :, 3] += rng.normal(scale=init_noise, size=(C, 3))
    points_init = points + rng.normal(scale=init_noise, size=(P, 3))

    return BalProblem(cam_poses=poses_init, cam_cals=cals, points=points_init,
                      obs_cam=obs_cam, obs_point=obs_point, obs_uv=uv)


def make_skewed_problem(num_cameras=1723, num_points=156000, mean_track=4.0,
                        max_track=40, noise_px=1.0, init_noise=0.05, seed=0,
                        radius=10.0, focal=800.0, cam_zipf=1.2):
    """BAL-realistic skew: power-law track lengths and heavily uneven
    per-camera observation counts (real BAL Ladybug per-camera counts are
    skewed; the uniform ring understates layout padding waste).

    Track length ~ 2 + Zipf(tail), capped; track start camera drawn from a
    Zipf popularity distribution over cameras, covering consecutive cameras
    (sequential-capture covisibility like the Ladybug rig)."""
    rng = np.random.default_rng(seed)
    C, P = num_cameras, num_points

    # power-law track lengths, mean ~ mean_track
    raw = rng.zipf(2.3, size=P).astype(np.int64) + 1
    lengths = np.clip(raw, 2, max_track)
    scale = mean_track / lengths.mean()
    lengths = np.clip((lengths * scale).astype(np.int64), 2, max_track)

    # camera popularity: Zipf over a random permutation of cameras
    pop = 1.0 / np.arange(1, C + 1) ** cam_zipf
    pop = pop[rng.permutation(C)]
    pop /= pop.sum()
    starts = rng.choice(C, size=P, p=pop)

    obs_cam = np.concatenate([
        (starts[j] + np.arange(lengths[j])) % C for j in range(P)
    ]).astype(np.int32)
    obs_point = np.repeat(np.arange(P, dtype=np.int32), lengths)

    # exact projections from the TRUE ring geometry
    angles = np.linspace(0, 2 * np.pi, C, endpoint=False)
    rng2 = np.random.default_rng(seed)
    centers = np.stack([radius * np.cos(angles), radius * np.sin(angles),
                        rng2.normal(scale=0.5, size=C)], axis=1)
    z = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 0.0, 1.0]), (C, 1))
    x = np.cross(up, z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y = np.cross(z, x)
    wRc = np.stack([x, y, z], axis=2)
    poses_true = np.concatenate([wRc, centers[:, :, None]], axis=2)
    points_true = rng2.normal(scale=2.0, size=(P, 3))
    cals = np.tile(np.array([focal, 1e-8, 1e-8]), (C, 1))

    Rw = poses_true[obs_cam, :, :3]
    tw = poses_true[obs_cam, :, 3]
    pc = np.einsum("mji,mj->mi", Rw, points_true[obs_point] - tw)
    z_safe = np.where(np.abs(pc[:, 2]) < 1e-6, 1e-6, pc[:, 2])
    pn = pc[:, :2] / z_safe[:, None]
    r2 = np.sum(pn * pn, axis=1)
    f, k1, k2 = cals[obs_cam, 0], cals[obs_cam, 1], cals[obs_cam, 2]
    g = f * (1 + k1 * r2 + k2 * r2 * r2)
    uv = g[:, None] * pn + rng.normal(scale=noise_px, size=(len(obs_cam), 2))
    keep = pc[:, 2] > 0.1
    obs_cam, obs_point, uv = obs_cam[keep], obs_point[keep], uv[keep]

    poses_init = poses_true.copy()
    poses_init[:, :, 3] += rng.normal(scale=init_noise, size=(C, 3))
    points_init = points_true + rng.normal(scale=init_noise, size=(P, 3))
    return BalProblem(cam_poses=poses_init, cam_cals=cals, points=points_init,
                      obs_cam=obs_cam, obs_point=obs_point, obs_uv=uv)
