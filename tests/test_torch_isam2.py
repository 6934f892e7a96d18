"""The port's ISAM2 (gtsam_personal_tpu_torch/nonlinear/isam2.py) against the
JAX engine, float64 on the CPU. Both engines are fed from the same numpy
arrays through add_variable / add_factor, update by update.

Streams stay within 64 variable slots and 128 factor slots, set from the
start, so that the JAX engine compiles each of its programs once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.core import manifolds as jman
from gtsam_personal_tpu.linear import noise as jnz
from gtsam_personal_tpu.nonlinear import isam2 as jisam
from gtsam_personal_tpu.slam import factors as jF
from gtsam_personal_tpu_torch.core import manifolds as tman
from gtsam_personal_tpu_torch.linear import noise as tnz
from gtsam_personal_tpu_torch.nonlinear import isam2 as tisam
from gtsam_personal_tpu_torch.slam import factors as F

F64 = torch.float64
SIGMAS = np.array([0.05, 0.05, 0.01])
PRIOR_SIGMAS = np.array([1e-3, 1e-3, 1e-4])
# One set of static values for every JAX engine here: fewer compilations.
# The CG runs to convergence (tolerance 1e-10, a cap it does not reach). Where
# it is cut at the cap before it converges, as block-Jacobi is at 30
# iterations on a 60-pose chain, the iterate depends on every rounding of the
# way there, and two implementations end 1e-3 apart: nothing to compare.
COMMON = dict(relinearize_threshold=0.02, cg_maxiter=400, cg_tol=1e-10,
              relin_chunk=64, min_fac_cap=128)


def _compose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1], a[1] + s * b[0] + c * b[1],
                     a[2] + b[2]])


def _between(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    inv = np.array([-(c * a[0] + s * a[1]), -(c * a[1] - s * a[0]), -a[2]])
    return _compose(inv, b)


def _make_manhattan(n=60, seed=3, closure_every=7):
    """The stream of tests/test_isam2.py:_make_manhattan: a grid walk with
    odometry and long-range loop closures, in numpy."""
    rng = np.random.default_rng(seed)
    gt = [np.zeros(3)]
    for k in range(1, n):
        turn = rng.choice([0.0, np.pi / 2, -np.pi / 2], p=[0.8, 0.1, 0.1])
        gt.append(_compose(gt[-1], np.array([1.0, 0.0, turn])))
    gt = np.stack(gt)
    edges = []
    for k in range(1, n):
        edges.append((k - 1, k, _between(gt[k - 1], gt[k])
                      + rng.normal(0, [0.05, 0.05, 0.01])))
    for k in range(closure_every, n, closure_every):
        j = int(rng.integers(0, max(1, k - closure_every)))
        edges.append((j, k, _between(gt[j], gt[k])
                      + rng.normal(0, [0.05, 0.05, 0.01])))
    return gt, edges


class Pair:
    """The JAX engine and the port's, fed the same arrays."""

    def __init__(self, **params):
        self.j = jisam.ISAM2(jisam.ISAM2Params(dtype=np.float64, **params))
        self.t = tisam.ISAM2(tisam.ISAM2Params(dtype=F64, **params),
                             device="cpu")
        self.stats = []

    def add_variable(self, group, value):
        i = self.j.add_variable(group, value)
        assert self.t.add_variable(group, value) == i
        return i

    def add_factor(self, name, jfn, tfn, groups, rdim, idx, meas, kind="unit",
                   data=None):
        self.j.add_factor(name, jfn, groups, rdim, idx, meas, jnz.NoiseModel(
            kind, None if data is None else jnp.asarray(data)))
        self.t.add_factor(name, tfn, groups, rdim, idx, meas, tnz.NoiseModel(
            kind, None if data is None else np.asarray(data)))

    def prior_se2(self, i, value, sigmas=PRIOR_SIGMAS):
        self.add_factor("prior_se2", jF.make_prior_residual("se2"),
                        F.make_prior_residual("se2"), ["se2"], 3, [i],
                        {"prior": value}, "diag", 1.0 / sigmas)

    def between_se2(self, i, j, measured):
        self.add_factor("between_se2", jF.make_between_residual("se2"),
                        F.make_between_residual("se2"), ["se2", "se2"], 3,
                        [i, j], {"measured": measured}, "diag", 1.0 / SIGMAS)

    def update(self, **kw):
        """Update both; records (JAX result, port result, gap), the gap
        being the largest difference over the linearization points theta and
        the tangents delta of every slot (the estimate is theta [+] delta)."""
        rj, rt = self.j.update(**kw), self.t.update(**kw)
        sj, st = self.j._state, self.t._state
        gap = max(max(np.abs(st.theta[g].numpy()
                             - np.asarray(sj.theta[g])).max(),
                      np.abs(st.delta[g].numpy()
                             - np.asarray(sj.delta[g]).T).max())
                  for g in st.theta)
        self.stats.append((rj, rt, gap))
        return rj, rt


def _stream(precond):
    """The 60-pose stream of tests/test_isam2.py, an update after every
    measurement, through both engines."""
    gt, edges = _make_manhattan(60)
    pair = Pair(precond=precond, **COMMON)
    pair.add_variable("se2", np.zeros(3))
    pair.prior_se2(0, np.zeros(3))
    pair.update()
    inits = [np.zeros(3)]
    for cnt, (i, j, m) in enumerate(edges):
        if j == len(inits):
            prev = (pair.j.estimate_array("se2")[i] if cnt % 10 == 0
                    else inits[i])
            inits.append(_compose(prev, m))
            pair.add_variable("se2", inits[-1])
        pair.between_se2(i, j, m)
        pair.update()
    pair.update()
    return pair


@pytest.fixture(scope="module", params=["jacobi", "chain:se2"])
def stream(request):
    return _stream(request.param)


def test_stream_relinearizes_the_same_rows(stream):
    rows = [(rj.relinearized_rows, rt.relinearized_rows)
            for rj, rt, _ in stream.stats]
    assert all(a == b for a, b in rows), rows
    assert max(a for a, _ in rows) > 8       # closures relinearize many rows
    assert [rt.factors_total for _, rt, _ in stream.stats] == [
        rj.factors_total for rj, _, _ in stream.stats]


def test_stream_takes_the_same_cg_iterations(stream):
    """Equal on the odometry updates; within 2 on the closures' updates,
    which take 10 to 190 iterations: CG's residual norm is not monotone, the
    two engines sum in another order, and after that many iterations the
    stop test can fire an iteration or two apart."""
    its = [(rj.cg_iterations, rt.cg_iterations) for rj, rt, _ in stream.stats]
    assert all(abs(a - b) <= 2 for a, b in its), its
    assert sum(a == b for a, b in its) >= len(its) - 6, its
    assert all(b < 400 for _, b in its)            # the early exit fires
    assert max(b for _, b in its) > 8


def test_stream_estimates_agree_after_every_update(stream):
    assert max(gap for _, _, gap in stream.stats) < 1e-9


def test_stream_final_error_agrees(stream):
    ej, et = stream.j.error(), stream.t.error()
    assert np.isfinite(et)
    np.testing.assert_allclose(et, ej, rtol=1e-9)
    i = 17
    np.testing.assert_array_equal(stream.t.estimate_at("se2", i),
                                  stream.t.estimate_array("se2")[i])


def test_multigroup_pose_landmark_stream():
    """Poses and point2 landmarks through one engine: pose_point_2d and
    bearing_range_2d observations, landmarks added when first seen."""
    rng = np.random.default_rng(0)
    lmk = np.array([[2.0, 1.0], [4.0, -1.0], [6.0, 2.0]])
    n = 20
    gt = np.stack([np.array([0.5 * k, 0.0, 0.0]) for k in range(n)])
    pair = Pair(precond="jacobi", **COMMON)
    pair.add_variable("se2", gt[0])
    pair.prior_se2(0, gt[0])
    seen = {}
    for k in range(1, n):
        m = _between(gt[k - 1], gt[k]) + rng.normal(0, [0.02, 0.02, 0.005])
        pair.add_variable("se2", _compose(gt[k - 1], m))
        pair.between_se2(k - 1, k, m)
        for li, l in enumerate(lmk):
            if abs(l[0] - 0.5 * k) >= 2.0:
                continue
            d = l - gt[k][:2]
            if li not in seen:
                seen[li] = pair.add_variable("point2",
                                             l + rng.normal(0, 0.2, 2))
            pair.add_factor(
                "pose_point_2d", jF.pose_point_2d_residual,
                F.pose_point_2d_residual, ["se2", "point2"], 2,
                [k, seen[li]], {"measured": d + rng.normal(0, 0.05, 2)},
                "diag", np.array([20.0, 20.0]))
            pair.add_factor(
                "bearing_range_2d", jF.bearing_range_2d_residual,
                F.bearing_range_2d_residual, ["se2", "point2"], 2,
                [k, seen[li]],
                {"bearing": np.arctan2(d[1], d[0]) + rng.normal(0, 0.01),
                 "range": np.linalg.norm(d) + rng.normal(0, 0.05)},
                "diag", np.array([100.0, 20.0]))
        pair.update()
    pair.update()
    assert all(rj.relinearized_rows == rt.relinearized_rows
               and rj.cg_iterations == rt.cg_iterations
               for rj, rt, _ in pair.stats)
    assert max(gap for _, _, gap in pair.stats) < 1e-8
    np.testing.assert_allclose(pair.t.error(), pair.j.error(), rtol=1e-9)
    est_l = pair.t.estimate_array("point2")
    assert est_l.shape == (3, 2) and np.abs(est_l - lmk).max() < 0.15


def test_superchain_multigroup_chain():
    """superchain:point2+vel2 is exact for this pure chain: PCG needs a
    handful of iterations despite the 1e8 stiffness ratio, in the port as in
    the JAX engine."""
    rng = np.random.default_rng(0)
    n = 25
    gt_p = np.cumsum(rng.normal(0.5, 0.1, size=(n, 2)), axis=0)
    gt_v = np.vstack([np.diff(gt_p, axis=0), np.zeros((1, 2))])
    jman.vector_space("vel2", 2)
    tman.vector_space("vel2", 2)

    def vel_odo(xs, meas):      # p_j - p_i - v_i (stiff)
        p_i, v_i, p_j = xs
        return p_j - p_i - v_i

    def anchor(xs, meas):
        return xs[0] - meas["z"]

    pair = Pair(cg_maxiter=30, cg_tol=1e-12,
                precond="superchain:point2+vel2", min_var_cap=n,
                min_fac_cap=2 * n)
    stiff, weak = np.full(2, 1e4), np.full(2, 1.0)

    def add(name, groups, idx, meas, w):
        pair.add_factor(name, anchor if len(groups) == 1 else vel_odo,
                        anchor if len(groups) == 1 else vel_odo, groups, 2,
                        idx, meas, "diag", w)

    pair.add_variable("point2", gt_p[0] + rng.normal(0, 0.1, 2))
    pair.add_variable("vel2", gt_v[0])
    add("p0", ["point2"], [0], {"z": gt_p[0]}, weak)
    add("v0", ["vel2"], [0], {"z": gt_v[0]}, weak)
    pair.update()
    for k in range(1, n):
        pair.add_variable("point2", gt_p[k] + rng.normal(0, 0.1, 2))
        pair.add_variable("vel2", gt_v[k] + rng.normal(0, 0.05, 2))
        add("vodo", ["point2", "vel2", "point2"], [k - 1, k - 1, k], {},
            stiff)
        add("pz", ["point2"], [k], {"z": gt_p[k] + rng.normal(0, 0.3, 2)},
            weak)
        rj, rt = pair.update()
        # The exact preconditioner converges in two or three iterations,
        # after which the residual sits at rounding level: whether it is
        # under 1e-12 of the entry residual is then a matter of noise, so
        # the counts are held to the bound and not to each other.
        assert rt.cg_iterations <= 12, rt.cg_iterations
        assert rt.relinearized_rows == rj.relinearized_rows
    # the stiff factors weigh 1e8 times the weak ones: rounding in the stiff
    # part of the gradient moves the weakly held directions by that much more
    assert max(gap for _, _, gap in pair.stats) < 1e-5
    assert np.abs(pair.t.estimate_array("point2") - gt_p).max() < 1.0
