"""Trajectory evaluation: alignment + absolute trajectory error (ATE).

JAX counterpart: gtsam_personal_tpu/slam/metrics.py (all of it; host numpy
there as here). Align an estimated trajectory to a reference with the best
SE(2)/SE(3)/Sim(3) (Umeyama) transform, then report translational ATE
statistics.
"""

from typing import Dict

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Best-fit transform dst ~ s R src + t (Umeyama 1991)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    d = src.shape[1]
    S = np.eye(d)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[-1, -1] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate(estimate: np.ndarray, reference: np.ndarray, align: bool = True,
        with_scale: bool = False) -> Dict[str, float]:
    """Absolute trajectory error of positions [N, d]."""
    est = np.asarray(estimate, dtype=np.float64)
    ref = np.asarray(reference, dtype=np.float64)
    if align:
        s, R, t = umeyama(est, ref, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - ref, axis=1)
    return {"rmse": float(np.sqrt(np.mean(err ** 2))),
            "mean": float(err.mean()), "median": float(np.median(err)),
            "max": float(err.max())}
