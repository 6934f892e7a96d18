"""Smart (structureless) projection factors.

JAX counterpart: gtsam_personal_tpu/sfm/smart.py (all of it; reference:
SmartProjectionFactor / SmartProjectionPoseFactor, slam/
SmartProjectionFactor.h; SmartStereoProjectionFactor and
SmartProjectionRigFactor). A smart factor spans the T cameras of a track
and eliminates its landmark inside the residual: the residual triangulates
the point (geometry/triangulation.py) and differentiating through that
argmin gives the variable-projection Jacobian the reference builds with
CameraSet::SchurComplement. Smart factors are ordinary `FactorBatch`es,
one per track length.

With `implicit=True` (the default) the DLT starts the refinement on the
poses as values (no tangent flows through the SVD, as `lax.custom_root`
takes none from its initial guess) and the refined point is differentiated
by the implicit function theorem; `implicit=False`, and the stereo and rig
factors, differentiate the DLT and the unrolled iterations as the JAX
package does. Degenerate and cheirality-failing tracks are weighted zero
(SmartProjectionFactor.h:173).
"""

from typing import Dict, List, Sequence

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import FactorBatch
from gtsam_personal_tpu_torch.geometry import cameras, se3
from gtsam_personal_tpu_torch.geometry import triangulation as tri
from gtsam_personal_tpu_torch.linear.noise import NoiseModel


def _weight(ok, like):
    """1 where the track is usable, else 0, in the dtype of `like`."""
    return ok.to(like.dtype)


def make_smart_residual(track_len: int, refine_iters: int = 3,
                        implicit: bool = True):
    """The residual [2T] of a track of T poses; meas: uv [T, 2] on the unit
    plane."""
    T = track_len

    def residual(xs, meas):
        poses = torch.stack(xs)                      # [T, 3, 4]
        uv = meas["uv"]
        if implicit:
            point, degenerate = tri.triangulate_dlt(poses.detach(), uv)
            point = tri.refine_nonlinear_implicit(poses, uv, point,
                                                  refine_iters)
        else:
            point, degenerate = tri.triangulate_dlt(poses, uv)
            point = tri.refine_nonlinear(poses, uv, point, refine_iters)
        depths = se3.transform_to(poses, point)[..., 2]
        ok = torch.logical_and(torch.logical_not(degenerate),
                               torch.all(depths > 1e-3))
        r = tri._reprojection(poses, uv, point)      # [T, 2]
        return _weight(ok, uv) * r.reshape(-1)

    residual.__name__ = f"smart_projection_T{T}"
    return residual


def _stereo_project(pose, point, cal):
    """(uL, uR, v) (reference: StereoCamera::project); cal = [fx, fy, cx,
    cy, baseline]."""
    pc = se3.transform_to(pose, point)
    z = pc[..., 2]
    z_safe = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    uL = cal[..., 0] * pc[..., 0] / z_safe + cal[..., 2]
    uR = cal[..., 0] * (pc[..., 0] - cal[..., 4]) / z_safe + cal[..., 2]
    v = cal[..., 1] * pc[..., 1] / z_safe + cal[..., 3]
    return torch.stack([uL, uR, v], dim=-1)


def _stereo_backproject(pose, m, cal):
    """Stereo measurements [..., 3] -> world points (disparity depth)."""
    disp = torch.clamp(m[..., 0] - m[..., 1], min=1e-6)
    z = cal[..., 0] * cal[..., 4] / disp
    x = z * (m[..., 0] - cal[..., 2]) / cal[..., 0]
    y = z * (m[..., 2] - cal[..., 3]) / cal[..., 1]
    return se3.transform_from(pose, torch.stack([x, y, z], dim=-1))


def make_smart_stereo_residual(track_len: int, refine_iters: int = 3):
    """Structureless stereo smart factor (gtsam_unstable/slam/
    SmartStereoProjectionFactor.h): the point is the mean of the disparity
    backprojections refined by Gauss-Newton on the stereo reprojection.
    meas: uvs [T, 3] (uL, uR, v), cal [5]."""
    T = track_len

    def residual(xs, meas):
        poses = torch.stack(xs)
        uvs, cal = meas["uvs"], meas["cal"]
        point = _stereo_backproject(poses, uvs, cal).mean(dim=0)

        def r_of(pt):
            return (_stereo_project(poses, pt, cal) - uvs).reshape(-1)
        eye = torch.eye(3, dtype=point.dtype, device=point.device)
        for _ in range(refine_iters):
            r = r_of(point)
            J = torch.func.jacfwd(r_of)(point)       # [3T, 3]
            H = J.transpose(0, 1) @ J + 1e-9 * eye
            point = point - tri.solve3(H, J.transpose(0, 1) @ r)
        depths = se3.transform_to(poses, point)[..., 2]
        return _weight(torch.all(depths > 1e-3), uvs) * r_of(point)

    residual.__name__ = f"smart_stereo_T{T}"
    return residual


def make_smart_rig_residual(track_len: int, refine_iters: int = 3):
    """SmartProjectionRigFactor (slam/SmartProjectionRigFactor.h): the
    variables are BODY poses; each observation carries its body-to-camera
    extrinsic and Cal3_S2 intrinsics. meas: uv [T, 2] pixels, bTc
    [T, 3, 4], cal [T, 5]."""
    T = track_len

    def residual(xs, meas):
        poses = se3.compose(torch.stack(xs), meas["bTc"])      # wTc
        cal, uv = meas["cal"], meas["uv"]
        # pixels -> unit plane (Cal3_S2 inverted) for the DLT
        x = ((uv[:, 0] - cal[:, 3]) / cal[:, 0]
             - cal[:, 2] * (uv[:, 1] - cal[:, 4]) / (cal[:, 0] * cal[:, 1]))
        y = (uv[:, 1] - cal[:, 4]) / cal[:, 1]
        uv_n = torch.stack([x, y], dim=1)
        point, degenerate = tri.triangulate_dlt(poses, uv_n)
        point = tri.refine_nonlinear(poses, uv_n, point, refine_iters)
        depths = se3.transform_to(poses, point)[..., 2]
        ok = torch.logical_and(torch.logical_not(degenerate),
                               torch.all(depths > 1e-3))
        r = cameras.project_point(poses, point, cal, "cal3_s2") - uv
        return _weight(ok, uv) * r.reshape(-1)

    residual.__name__ = f"smart_rig_T{T}"
    return residual


def _by_length(tracks, min_len):
    by_len: Dict[int, List[int]] = {}
    for k, t in enumerate(tracks):
        by_len.setdefault(len(t), []).append(k)
    return [(T, ks) for T, ks in sorted(by_len.items()) if T >= min_len]


def _batch(name, fn, T, rdim, pose_group, idx, meas, sigma, device, dtype):
    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)
    return FactorBatch(
        name, fn, (pose_group,) * T, rdim,
        torch.tensor(np.asarray(idx, dtype=np.int64), device=device),
        {k: t(v) for k, v in meas.items()},
        NoiseModel("diag", torch.full((len(idx), rdim), 1.0 / sigma,
                                      device=device, dtype=dtype)))


def build_smart_batches(tracks: Sequence[Sequence[int]],
                        measurements: Sequence[np.ndarray],
                        sigma: float = 1.0, pose_group: str = "se3", *,
                        device, dtype=torch.float64) -> List[FactorBatch]:
    """Tracks grouped by length into FactorBatches: tracks[k] the camera
    indices of track k, measurements[k] its [T_k, 2] unit-plane
    measurements; tracks shorter than 2 are dropped."""
    return [_batch(f"smart_projection_T{T}", make_smart_residual(T), T,
                   2 * T, pose_group, [tracks[k] for k in ks],
                   {"uv": np.asarray([measurements[k] for k in ks])}, sigma,
                   device, dtype)
            for T, ks in _by_length(tracks, 2)]


def build_smart_stereo_batches(tracks: Sequence[Sequence[int]],
                               measurements: Sequence[np.ndarray], cal,
                               sigma: float = 1.0, pose_group: str = "se3",
                               *, device,
                               dtype=torch.float64) -> List[FactorBatch]:
    """Stereo tracks by length; cal [5] (fx, fy, cx, cy, baseline), shared
    by the rig (SmartStereoProjectionPoseFactor)."""
    cal = np.asarray(cal, dtype=np.float64)
    return [_batch(f"smart_stereo_T{T}", make_smart_stereo_residual(T), T,
                   3 * T, pose_group, [tracks[k] for k in ks],
                   {"uvs": np.asarray([measurements[k] for k in ks]),
                    "cal": np.tile(cal, (len(ks), 1))}, sigma, device, dtype)
            for T, ks in _by_length(tracks, 1)]


def build_smart_rig_batches(tracks: Sequence[Sequence[int]],
                            measurements: Sequence[np.ndarray],
                            cam_ids: Sequence[Sequence[int]],
                            rig_bTc: np.ndarray, rig_cal: np.ndarray,
                            sigma: float = 1.0, pose_group: str = "se3", *,
                            device, dtype=torch.float64) -> List[FactorBatch]:
    """tracks[k]: body-pose indices; cam_ids[k]: the rig camera of each
    observation; rig_bTc [C, 3, 4], rig_cal [C, 5]."""
    out = []
    for T, ks in _by_length(tracks, 2):
        cams = np.asarray([cam_ids[k] for k in ks], dtype=np.int64)
        out.append(_batch(
            f"smart_rig_T{T}", make_smart_rig_residual(T), T, 2 * T,
            pose_group, [tracks[k] for k in ks],
            {"uv": np.asarray([measurements[k] for k in ks]),
             "bTc": np.asarray(rig_bTc)[cams],
             "cal": np.asarray(rig_cal)[cams]},
            sigma, device, dtype))
    return out
