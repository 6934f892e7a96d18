"""BAL (Bundle Adjustment in the Large) and Bundler file I/O, in numpy.

JAX counterpart: gtsam_personal_tpu/sfm/bal.py:BalProblem, load_bal,
write_bal, load_bundler. The JAX module imports jax.numpy at module level, so
the port carries its own copy; the arrays it returns are bit-identical.

Reference parity: SfmData::FromBalFile (gtsam/sfm/SfmData.cpp:189-248):
- measurements read as (u, -v)  [BAL y-axis flip, SfmData.cpp:210]
- camera pose converted from the BAL/OpenGL convention to a camera-to-world
  GTSAM pose: wRc = R^T * diag(1,-1,-1), wtc = R^T(-t)  [openGL2gtsam,
  SfmData.cpp:79-84]
- calibration is Cal3Bundler (f, k1, k2).

`sfm/ba.py:state_from_bal` moves a `BalProblem` onto a torch device.
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class BalProblem:
    cam_poses: np.ndarray    # [C, 3, 4] camera-to-world (GTSAM convention)
    cam_cals: np.ndarray     # [C, 3] Cal3Bundler (f, k1, k2)
    points: np.ndarray       # [P, 3]
    obs_cam: np.ndarray      # [M] int32
    obs_point: np.ndarray    # [M] int32
    obs_uv: np.ndarray       # [M, 2]

    @property
    def num_cameras(self):
        return self.cam_poses.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    @property
    def num_observations(self):
        return self.obs_uv.shape[0]


def _rodrigues(w):
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        a = np.where(theta > 1e-12, w / np.maximum(theta, 1e-12), np.zeros_like(w))
    c = np.cos(theta)[..., None]
    s = np.sin(theta)[..., None]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -a[..., 2], a[..., 1]
    K[..., 1, 0], K[..., 1, 2] = a[..., 2], -a[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -a[..., 1], a[..., 0]
    I = np.broadcast_to(np.eye(3), K.shape)
    aaT = a[..., :, None] * a[..., None, :]
    return c * I + s * K + (1 - c) * aaT


def _logmap(R):
    """Rotation matrix -> axis-angle, the branches of the JAX package's
    geometry/so3.py:logmap (generic atan2, Taylor near 0, diagonal axis
    extraction near pi) for one matrix in numpy."""
    v = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]])
    s2 = float(v @ v)
    c = 0.5 * (np.trace(R) - 1.0)
    if s2 >= 1e-12:
        s = np.sqrt(s2)
        return (np.arctan2(s, c) / s) * v
    if c > 0.0:
        return (1.0 + s2 / 6.0 + 7.0 * s2 * s2 / 360.0) * v
    theta = np.arctan2(np.sqrt(s2 + 1e-30), c)
    diag = np.diagonal(R)
    k = int(np.argmax(diag))
    ak = np.sqrt((max(diag[k], -1.0 + 1e-12) + 1.0) * 0.5)
    a = 0.25 * (R[:, k] + R[k, :]) / (1.0 if ak < 1e-12 else ak)
    a[k] = ak
    a = a / np.sqrt(max(float(a @ a), 1e-24))
    return theta * (-1.0 if a @ v < 0.0 else 1.0) * a


def load_bal(path, dtype=np.float64) -> BalProblem:
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    C, P, M = int(next(it)), int(next(it)), int(next(it))
    arr = np.array(tokens[3:], dtype=np.float64)
    obs = arr[: 4 * M].reshape(M, 4)
    cams = arr[4 * M: 4 * M + 9 * C].reshape(C, 9)
    pts = arr[4 * M + 9 * C: 4 * M + 9 * C + 3 * P].reshape(P, 3)

    obs_cam = obs[:, 0].astype(np.int32)
    obs_point = obs[:, 1].astype(np.int32)
    obs_uv = obs[:, 2:4].copy()
    obs_uv[:, 1] *= -1.0  # BAL y-flip (SfmData.cpp:210)

    R_bal = _rodrigues(cams[:, :3])          # world->camera, OpenGL z-back
    t_bal = cams[:, 3:6]
    R90 = np.diag([1.0, -1.0, -1.0])
    wRc = np.swapaxes(R_bal, -1, -2) @ R90   # openGL2gtsam
    wtc = np.einsum("cij,cj->ci", np.swapaxes(R_bal, -1, -2), -t_bal)
    cam_poses = np.concatenate([wRc, wtc[:, :, None]], axis=2)

    return BalProblem(
        cam_poses=cam_poses.astype(dtype),
        cam_cals=cams[:, 6:9].astype(dtype),
        points=pts.astype(dtype),
        obs_cam=obs_cam, obs_point=obs_point,
        obs_uv=obs_uv.astype(dtype))


def write_bal(path, prob: BalProblem):
    """writeBAL analogue (gtsam/sfm/SfmData.cpp:250+), inverse conversions."""
    C, P, M = prob.num_cameras, prob.num_points, prob.num_observations
    R90 = np.diag([1.0, -1.0, -1.0])
    with open(path, "w") as f:
        f.write(f"{C} {P} {M}\n")
        for k in range(M):
            f.write(f"{prob.obs_cam[k]} {prob.obs_point[k]} "
                    f"{prob.obs_uv[k,0]} {-prob.obs_uv[k,1]}\n")
        for c in range(C):
            wRc = prob.cam_poses[c, :, :3]
            wtc = prob.cam_poses[c, :, 3]
            R_bal = R90 @ wRc.T
            t_bal = -(R_bal @ wtc)
            w = _logmap(R_bal)             # rodrigues vector of R_bal
            for v in (*w, *t_bal, *prob.cam_cals[c]):
                f.write(f"{v}\n")
        for p in range(P):
            for v in prob.points[p]:
                f.write(f"{v}\n")


def load_bundler(path, dtype=np.float64) -> BalProblem:
    """Bundler .out reader (reference: SfmData::FromBundlerFile,
    gtsam/sfm/SfmData.cpp:120-188): header line, (nrPoses, nrPoints), per
    camera (f k1 k2; R rows; t) in the Bundler/OpenGL convention (converted
    by openGL2gtsam like BAL), per point (xyz; rgb; view list of
    (cam_idx, sift_idx, u, v) with the v-axis flip)."""
    with open(path) as f:
        first = f.readline()
        if not first.startswith("#"):
            raise ValueError("not a Bundler .out file (missing header)")
        tokens = f.read().split()
    it = 0

    def take(n):
        nonlocal it
        out = tokens[it:it + n]
        it += n
        return out

    C, P = int(take(1)[0]), int(take(1)[0])
    cam_poses = np.zeros((C, 3, 4))
    cam_cals = np.zeros((C, 3))
    R90 = np.diag([1.0, -1.0, -1.0])
    for c in range(C):
        f_, k1, k2 = (float(v) for v in take(3))
        R = np.array([float(v) for v in take(9)]).reshape(3, 3)
        t = np.array([float(v) for v in take(3)])
        if not R.any():
            raise ValueError(f"zero rotation matrix for camera {c}")
        wRc = R.T @ R90
        wtc = R.T @ (-t)
        cam_poses[c] = np.concatenate([wRc, wtc[:, None]], axis=1)
        cam_cals[c] = (f_, k1, k2)

    points = np.zeros((P, 3))
    obs_cam, obs_point, obs_uv = [], [], []
    for p in range(P):
        points[p] = [float(v) for v in take(3)]
        take(3)                                  # rgb
        nvis = int(take(1)[0])
        for _ in range(nvis):
            ci, _sift, u, v = take(4)
            obs_cam.append(int(ci))
            obs_point.append(p)
            obs_uv.append((float(u), -float(v)))  # Bundler v-flip

    return BalProblem(
        cam_poses=cam_poses.astype(dtype), cam_cals=cam_cals.astype(dtype),
        points=points.astype(dtype),
        obs_cam=np.asarray(obs_cam, dtype=np.int32),
        obs_point=np.asarray(obs_point, dtype=np.int32),
        obs_uv=np.asarray(obs_uv, dtype=dtype))
