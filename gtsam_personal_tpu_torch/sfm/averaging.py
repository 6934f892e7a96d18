"""SfM averaging: Karcher mean, translation recovery, MFAS.

JAX counterpart: gtsam_personal_tpu/sfm/averaging.py (all of it;
reference: slam/KarcherMeanFactor.h FindKarcherMean, sfm/
TranslationRecovery.h and sfm/MFAS.h):
- `karcher_mean_so3`: the intrinsic mean of rotations by Riemannian
  gradient descent, a loop of batched logmaps on the device;
- `translation_recovery`: 1dsfm-style translation averaging from unit
  directions, solved as a factor graph with the package's LM;
- `mfas_order` and `mfas_outlier_weights`: the greedy minimum-feedback-arc-
  set ordering along a projection axis, numpy on the host as in the JAX
  package.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.geometry import so3
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers


def karcher_mean_so3(rotations, iters: int = 20):
    """Intrinsic (Karcher) mean on SO(3) of [N, 3, 3] rotations (a tensor,
    on its device): R_{k+1} = R_k Exp(mean log(R_k^T R_i))."""
    Rs = rotations
    R = Rs[0]
    for _ in range(iters):
        logs = so3.logmap(R.transpose(-1, -2) @ Rs)
        R = R @ so3.expmap(logs.mean(0))
    return R


def _direction_residual(xs, meas):
    """The direction from t_i to t_j against the measured unit vector
    (reference: TranslationFactor); the chord difference keeps it smooth at
    every separation."""
    ti, tj = xs
    d = tj - ti
    norm = torch.sqrt((d * d).sum(-1, keepdim=True) + 1e-12)
    return d / norm - meas["w_iZj"]


def _anchor_residual(xs, meas):
    return xs[0] - meas["p"]


def translation_recovery(edges_ij: np.ndarray, directions: np.ndarray,
                         scale: float = 1.0, seed: int = 0, params=None, *,
                         device="cuda", dtype=torch.float64) -> np.ndarray:
    """Global positions [n, 3] (numpy) from pairwise unit directions (gauge:
    t_0 = 0, the first baseline's length = scale). The start is the JAX
    package's numpy draw, `default_rng(seed).normal(size=(n, 3))`."""
    dev = config.device(device)
    n = int(edges_ij.max()) + 1
    t3 = manifolds.vector_space("trans_avg", 3)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    batch = FactorBatch(
        "translation_direction", _direction_residual, (t3.name, t3.name), 3,
        idx(edges_ij), {"w_iZj": t(directions)}, NoiseModel("unit"))
    a0 = FactorBatch("anchor0", _anchor_residual, (t3.name,), 3,
                     idx([[0]]), {"p": t(np.zeros((1, 3)))},
                     NoiseModel("diag", t(np.full((1, 3), 1e3))))
    # fix the scale: node edges_ij[0, 1] at scale * the first direction
    j0 = int(edges_ij[0, 1])
    a1 = FactorBatch("anchor1", _anchor_residual, (t3.name,), 3,
                     idx([[j0]]), {"p": t(scale * np.asarray(directions)[:1])},
                     NoiseModel("diag", t(np.full((1, 3), 1e3))))
    graph = FactorGraph([a0, a1, batch])
    rng = np.random.default_rng(seed)
    init = Values({t3.name: t(rng.normal(scale=1.0, size=(n, 3)))})
    params = params or optimizers.Params(max_iterations=100)
    res = optimizers.optimize_lm(graph, init, params)
    out = res.values[t3.name].cpu().numpy()
    return out - out[0]


def mfas_order(edges_ij: np.ndarray, directions: np.ndarray,
               axis: np.ndarray) -> List[int]:
    """Minimum-feedback-arc-set ordering of the nodes along a projection
    axis (greedy heuristic, reference: MFAS::computeOrdering)."""
    n = int(edges_ij.max()) + 1
    w = directions @ np.asarray(axis)
    out_w = np.zeros(n)
    in_w = np.zeros(n)
    adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    for k, (i, j) in enumerate(edges_ij):
        wk = w[k]
        if wk >= 0:
            out_w[i] += wk
            in_w[j] += wk
            adj[i].append((j, wk))
            adj[j].append((i, -wk))
        else:
            out_w[j] += -wk
            in_w[i] += -wk
            adj[j].append((i, -wk))
            adj[i].append((j, wk))
    order = []
    alive = np.ones(n, dtype=bool)
    for _ in range(n):
        score = np.where(alive, (out_w + 1e-9) / (in_w + 1e-9), -np.inf)
        u = int(np.argmax(score))
        order.append(u)
        alive[u] = False
        for v, wv in adj[u]:
            if alive[v]:
                if wv >= 0:
                    in_w[v] -= wv
                else:
                    out_w[v] -= -wv
    return order


def mfas_outlier_weights(edges_ij: np.ndarray, directions: np.ndarray,
                         axes: Sequence[np.ndarray]) -> np.ndarray:
    """Accumulated inconsistency weight per edge over several projection
    axes (reference: MFAS-based outlier rejection in translation
    averaging)."""
    total = np.zeros(len(edges_ij))
    for axis in axes:
        order = mfas_order(edges_ij, directions, axis)
        pos = np.empty(len(order), dtype=int)
        pos[order] = np.arange(len(order))
        w = directions @ np.asarray(axis)
        for k, (i, j) in enumerate(edges_ij):
            # the edge says i before j when its projected weight is positive
            if w[k] >= 0 and pos[i] > pos[j]:
                total[k] += w[k]
            elif w[k] < 0 and pos[j] > pos[i]:
                total[k] += -w[k]
    return total
