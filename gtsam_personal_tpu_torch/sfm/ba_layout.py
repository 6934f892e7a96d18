"""The GPU index plan of the BA engine: observations sorted camera-major.

JAX counterpart: the index plan inside
gtsam_personal_tpu/sfm/ba_pack.py:PackLayout.build (lines 217-322). The JAX
plan packs cameras and landmarks into the TPU's (8, 128) tiles with
stack/wrap classes, dead slots and a camera mask. None of that is needed on
a GPU: here every observation is one row of flat [k, M] tensors, rows are
sorted by camera (stable, so a camera's rows keep their input order), and
per-camera and per-landmark sums are reductions over `cam_of` / `pt_of`.
There are no dead rows, so there is no mask.

The plan is built once in numpy and moved to the device once.
"""

from typing import NamedTuple

import numpy as np
import torch


class BALayout(NamedTuple):
    C: int
    P: int
    M: int
    cam_of: torch.Tensor       # [M] int64, camera of each row (sorted)
    pt_of: torch.Tensor        # [M] int64, landmark of each row
    uv_cm: torch.Tensor        # [2, M] measurement of each row
    cam_ptr: torch.Tensor      # [C+1] int64, rows of camera c: ptr[c]:ptr[c+1]
    pt_ptr: torch.Tensor       # [P+1] int64, offsets of each landmark's
                               # rows in landmark-major order
    obs_of_slot: torch.Tensor  # [M] int64, original observation of each row


def build_layout(obs_cam, obs_point, obs_uv, C: int, P: int, *, device,
                 dtype) -> BALayout:
    """Index plan for M observations (numpy or host arrays) of C cameras
    and P landmarks; uv_cm is cast to `dtype`."""
    cam = np.asarray(obs_cam, dtype=np.int64)
    pt = np.asarray(obs_point, dtype=np.int64)
    uv = np.asarray(obs_uv)
    M = cam.shape[0]
    if pt.shape != (M,) or uv.shape != (M, 2):
        raise ValueError(f"observations disagree in length: cam {cam.shape}, "
                         f"point {pt.shape}, uv {uv.shape}")
    if M and (cam.min() < 0 or cam.max() >= C or pt.min() < 0
              or pt.max() >= P):
        raise ValueError("observation index out of range")
    order = np.argsort(cam, kind="stable")

    def ptr(ids, n):
        out = np.zeros(n + 1, dtype=np.int64)
        out[1:] = np.cumsum(np.bincount(ids, minlength=n))
        return out

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return BALayout(
        C, P, M,
        dev(cam[order], torch.int64), dev(pt[order], torch.int64),
        dev(uv[order].T, dtype),
        dev(ptr(cam, C), torch.int64), dev(ptr(pt, P), torch.int64),
        dev(order, torch.int64))
