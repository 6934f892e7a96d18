"""The port's averaging (sfm/averaging.py: Karcher mean, translation
recovery, MFAS) against the JAX package, in float64 on the CPU, on
tests/test_utils_averaging.py's cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.geometry import so3 as jso3
from gtsam_personal_tpu.sfm import averaging as javg
from gtsam_personal_tpu_torch.geometry import so3
from gtsam_personal_tpu_torch.sfm import averaging as avg
from gtsam_personal_tpu_torch.slam import metrics


def _karcher_inputs(seed=1):
    rng = np.random.default_rng(seed)
    base = np.asarray(jso3.expmap(jnp.asarray([0.4, -0.1, 0.2])))
    Rs = np.stack([base @ np.asarray(jso3.expmap(jnp.asarray(
        rng.normal(scale=0.05, size=3)))) for _ in range(20)])
    return base, Rs


def test_karcher_mean_matches():
    """test_utils_averaging's case: within 0.03 rad of the base, and equal
    to the JAX package's mean to 1e-12."""
    base, Rs = _karcher_inputs()
    mean = avg.karcher_mean_so3(torch.tensor(Rs)).numpy()
    jmean = np.asarray(javg.karcher_mean_so3(jnp.asarray(Rs)))
    np.testing.assert_allclose(mean, jmean, rtol=0, atol=1e-12)
    err = np.linalg.norm(so3.logmap(torch.tensor(base.T @ mean)).numpy())
    assert err < 0.03


def _translation_problem(seed=2, n=6):
    rng = np.random.default_rng(seed)
    truth = rng.normal(scale=2.0, size=(n, 3))
    truth -= truth[0]
    edges, dirs = [], []
    for i in range(n):
        for j in range(i + 1, n):
            d = truth[j] - truth[i]
            edges.append((i, j))
            dirs.append(d / np.linalg.norm(d))
    return truth, np.asarray(edges), np.asarray(dirs)


@pytest.mark.parametrize("seed", [0, 7])
def test_translation_recovery_matches(seed):
    """test_utils_averaging's case: the positions to 1e-3 of the truth
    (similarity-aligned ATE) and to 1e-9 of the JAX package's, from the
    same numpy start (`seed`)."""
    truth, edges, dirs = _translation_problem()
    scale0 = np.linalg.norm(truth[edges[0, 1]] - truth[edges[0, 0]])
    est = avg.translation_recovery(edges, dirs, scale=scale0, seed=seed,
                                   device="cpu")
    jest = javg.translation_recovery(edges, dirs, scale=scale0, seed=seed)
    np.testing.assert_allclose(est, jest, rtol=0, atol=1e-9)
    out = metrics.ate(est, truth, align=True, with_scale=True)
    assert out["rmse"] < 1e-3, out


def test_mfas_order_consistent():
    """Points on a line with consistent directions: the MFAS order is the
    line's order and no edge is inconsistent, as in the JAX package."""
    truth = np.array([[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0]])
    edges, dirs = [], []
    for i in range(4):
        for j in range(i + 1, 4):
            d = truth[j] - truth[i]
            edges.append((i, j))
            dirs.append(d / np.linalg.norm(d))
    edges, dirs = np.asarray(edges), np.asarray(dirs)
    axis = np.array([1.0, 0, 0])
    order = avg.mfas_order(edges, dirs, axis)
    assert order == [0, 1, 2, 3] == javg.mfas_order(edges, dirs, axis)
    w = avg.mfas_outlier_weights(edges, dirs, [axis])
    assert w.max() < 1e-12


def test_mfas_outliers_match():
    """A 12-node graph with 3 flipped directions, over 5 random axes: the
    same order and the same weights as the JAX package (the greedy order
    need not flag every flipped edge; it flags some)."""
    rng = np.random.default_rng(9)
    truth, edges, dirs = _translation_problem(seed=5, n=12)
    flipped = rng.choice(len(edges), size=3, replace=False)
    dirs = dirs.copy()
    dirs[flipped] *= -1
    axes = [a / np.linalg.norm(a) for a in rng.normal(size=(5, 3))]
    for axis in axes:
        assert avg.mfas_order(edges, dirs, axis) == \
            javg.mfas_order(edges, dirs, axis)
    w = avg.mfas_outlier_weights(edges, dirs, axes)
    np.testing.assert_array_equal(w, javg.mfas_outlier_weights(edges, dirs,
                                                               axes))
    assert w[flipped].max() > 0
