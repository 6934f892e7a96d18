"""Bundle-adjustment state, observations and the moves between numpy,
torch and the JAX package.

JAX counterpart: gtsam_personal_tpu/sfm/ba.py:BAState, BAObservations,
state_from_bal, _residual_one, retract_ba (lines 38-69 and 532).

Cameras follow the reference's PinholeCamera<Cal3Bundler> 9-dof manifold
(pose 6 + calibration 3); the camera tangent is [pose xi, dcal].
`state_from_numpy` / `observations_from_numpy` carry state across from any
array source (a `BalProblem`, or `np.asarray` of a JAX `BAState`).
"""

from typing import NamedTuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.geometry import cameras as cam_geo, se3
from gtsam_personal_tpu_torch.sfm.bal import BalProblem


class BAState(NamedTuple):
    cam_poses: torch.Tensor   # [C, 3, 4] camera-to-world
    cam_cals: torch.Tensor    # [C, 3]    Cal3Bundler (f, k1, k2)
    points: torch.Tensor      # [P, 3]


class BAObservations(NamedTuple):
    cam: torch.Tensor         # [M] int64
    point: torch.Tensor       # [M] int64
    uv: torch.Tensor          # [M, 2]


def state_from_numpy(cam_poses, cam_cals, points, *, device, dtype):
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return BAState(t(cam_poses), t(cam_cals), t(points))


def observations_from_numpy(cam, point, uv, *, device, dtype):
    def idx(a):
        return torch.tensor(np.asarray(a, dtype=np.int64), device=device)
    return BAObservations(idx(cam), idx(point),
                          torch.tensor(np.asarray(uv), dtype=dtype,
                                       device=device))


def state_to_numpy(state: BAState) -> BAState:
    """The same state as host numpy arrays (one device-to-host copy each)."""
    return BAState(*(x.detach().cpu().numpy() for x in state))


def state_from_bal(prob: BalProblem, *, device, dtype):
    """(BAState, BAObservations) of a BAL-shaped problem on `device`."""
    return (state_from_numpy(prob.cam_poses, prob.cam_cals, prob.points,
                             device=device, dtype=dtype),
            observations_from_numpy(prob.obs_cam, prob.obs_point,
                                    prob.obs_uv, device=device, dtype=dtype))


def _residual_one(pose, cal, point, uv):
    """Reprojection residual, batched over leading axes (reference:
    GeneralSFMFactor::evaluateError = camera.project(point) - measured)."""
    return cam_geo.project_point(pose, point, cal, "cal3bundler") - uv


def retract_ba(state: BAState, xc, xp) -> BAState:
    """Apply a step: camera poses by the right retraction, calibrations and
    points by addition. xc [C, 9] = [xi, dcal], xp [P, 3]."""
    return BAState(se3.retract(state.cam_poses, xc[:, :6]),
                   state.cam_cals + xc[:, 6:9], state.points + xp)
