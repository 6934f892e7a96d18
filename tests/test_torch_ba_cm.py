"""The port's camera-major BA engine (gtsam_personal_tpu_torch.sfm.ba)
against the JAX one (gtsam_personal_tpu.sfm.ba), in float64 on the CPU.

The same seeded problems go through both; the JAX programs compile once
per module. Per-observation outputs are compared in observation order
(the JAX dense slot layout and the port's sorted rows each map back),
steps in camera and landmark order. Tolerances: 1e-12 relative to the
largest entry for linearizations and errors (the same arithmetic to
rounding), 1e-9 relative for steps and LM runs (a CG of up to 100
iterations, each a sum in another order)."""

import jax
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.sfm import ba as jba, bal as jbal, synthetic as jsyn
from gtsam_personal_tpu_torch.sfm import ba, bal

F64 = torch.float64
j_linearize = jax.jit(jba.linearize_ba)
j_error = jax.jit(jba.ba_error)
j_linearize_cm = jax.jit(jba.linearize_ba_cm)
j_error_cm = jax.jit(jba.ba_error_cm)
j_step_cm = jax.jit(jba.solve_ba_step_cm, static_argnames=("cg_maxiter",
                                                           "cg_tol"))
j_step = jax.jit(jba.solve_ba_step, static_argnames=("cg_maxiter", "cg_tol"))


class Case:
    """One problem in both packages."""

    def __init__(self, prob):
        C, P = prob.num_cameras, prob.num_points
        self.prob = prob
        self.jstate, self.jobs = jba.state_from_bal(prob)
        self.jl = jba.make_layout(self.jobs, C, P)
        self.state, self.obs = ba.state_from_bal(prob, device="cpu",
                                                 dtype=F64)
        self.pl = ba.make_layout(self.obs, C, P)

    def jax_cm_to_obs(self, x):
        """JAX [k..., C, Q] slots -> observation order [k..., M]."""
        x = np.asarray(x)
        x = x.reshape(x.shape[:-2] + (-1,))
        g = np.asarray(self.jl.g_cam)
        live = g < self.jl.M
        out = np.empty(x.shape[:-1] + (self.jl.M,))
        out[..., g[live]] = x[..., live]
        return out

    def rows_to_obs(self, x):
        out = torch.empty_like(x)
        out[..., self.pl.obs_of_slot] = x
        return out.numpy()


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, (
        np.abs(got - want).max() / scale)


def _skewed29():
    return jsyn.make_skewed_problem(num_cameras=29, num_points=300,
                                    mean_track=4.0, max_track=24, seed=5,
                                    cam_zipf=1.2)


@pytest.fixture(scope="module")
def case29():
    return Case(_skewed29())


@pytest.fixture(scope="module")
def case_file(tmp_path_factory):
    """A write_bal file of the 29-camera problem, read by each package's
    load_bal: other numbers (the file's rotations are Rodrigues vectors),
    the same shapes, so the JAX programs compiled for case29 serve it."""
    path = str(tmp_path_factory.mktemp("bal") / "skewed.txt")
    bal.write_bal(path, _skewed29())
    c = Case(jbal.load_bal(path))
    c.state, c.obs = ba.state_from_bal(bal.load_bal(path), device="cpu",
                                       dtype=F64)
    c.pl = ba.make_layout(c.obs, c.prob.num_cameras, c.prob.num_points)
    return c


@pytest.fixture(params=["case29", "case_file"])
def case(request):
    return request.getfixturevalue(request.param)


def test_linearize_ba(case):
    want = j_linearize(case.jstate, case.jobs)
    got = ba.linearize_ba(case.state, case.obs)
    for g, w in zip(got, want):
        _close(g, w, 1e-12)


def test_linearize_ba_cm(case):
    want = j_linearize_cm(case.jstate, case.jobs, case.jl)
    got = ba.linearize_ba_cm(case.state, case.obs, case.pl)
    for g, w in zip(got, want):
        _close(case.rows_to_obs(g), case.jax_cm_to_obs(w), 1e-12)


def test_errors(case):
    want = float(j_error(case.jstate, case.jobs))
    for got in (ba.ba_error(case.state, case.obs),
                ba.ba_error_cm(case.state, case.obs, case.pl)):
        assert abs(float(got) - want) <= 1e-12 * want
    assert abs(float(j_error_cm(case.jstate, case.jobs, case.jl))
               - want) <= 1e-12 * want


@pytest.mark.parametrize("lam", [1e-2, 1.0])
def test_solve_ba_step_cm(case, lam):
    """The step with CG run to convergence (cap 300 not reached, tolerance
    1e-12). Cut short at the engine's default tolerance 1e-6 the iterates
    of two implementations drift apart with the Schur system's condition
    (1e-5 at lam = 1 on the 29-camera case), as in tests/test_torch_ba.py;
    the early exit itself is held to the masked loop below."""
    want = j_step_cm(case.jstate, case.jobs, case.jl, lam, cg_maxiter=300,
                     cg_tol=1e-12)
    got = ba.solve_ba_step_cm(case.state, case.obs, case.pl, lam,
                              cg_maxiter=300, cg_tol=1e-12)
    for g, w in zip(got, want):
        _close(g, w, 1e-9)


def test_solve_ba_step_row_major(case29):
    c = case29
    want = j_step(c.jstate, c.jobs, c.jl, 1.0, cg_maxiter=300,
                  cg_tol=1e-12)
    got = ba.solve_ba_step(c.state, c.obs, c.pl, 1.0, cg_maxiter=300,
                           cg_tol=1e-12)
    for g, w in zip(got, want):
        _close(g, w, 1e-9)


def test_step_early_exit_equals_masked_loop(case29):
    """At the engine's defaults (cap 100, tolerance 1e-6) the step that
    reads CG's flag every 8 iterations and stops equals, bit for bit, the
    one that runs all 100 iterations masked (what the JAX while_loop
    computes)."""
    c = case29
    lin = ba.linearize_ba_cm(c.state, c.obs, c.pl)
    red = ba._reduce_cache(c.pl, lin)
    seen = {}

    def probe(label, **info):
        seen.update(info)
    early = ba._solve_from_lin(c.pl, lin, red, 1e-4, check_every=8,
                               probe=probe)
    masked = ba._solve_from_lin(c.pl, lin, red, 1e-4, check_every=None)
    for a, b in zip(early, masked):
        assert torch.equal(a, b)
    assert 0 < int(seen["iterations"]) < 100
    for a, b in zip(early, ba.solve_ba_step_cm(c.state, c.obs, c.pl, 1e-4)):
        assert torch.equal(a, b)


def test_pcg_masked_equals_early_exit_and_jax():
    """pcg on a seeded SPD system: the masked loop (no host read), the
    early exit every 8 iterations and JAX's while_loop agree."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(40, 40))
    A = A @ A.T + 0.5 * np.eye(40)
    b = rng.normal(size=40)
    d = 1.0 / np.diag(A)
    At, bt, dt = (torch.tensor(x) for x in (A, b, d))
    want = np.asarray(jax.jit(lambda b: jba.pcg(
        lambda x: A @ x, b, lambda r: d * r, 60, 1e-8))(b))
    masked = ba.pcg(lambda x: At @ x, bt, lambda r: dt * r, 60, 1e-8,
                    check_every=None)
    early = ba.pcg(lambda x: At @ x, bt, lambda r: dt * r, 60, 1e-8)
    assert torch.equal(masked, early)
    _close(early, want, 1e-9)
    # the early exit stops before the cap: the iterations it ran
    _, _, iters = ba._pcg(lambda x: At @ x, bt, lambda r: dt * r, 60, 1e-8,
                          8)
    assert 0 < int(iters) < 60


def test_optimize_ba(case):
    c = case
    js, je, jit = jba.optimize_ba(c.jstate, c.jobs, c.jl, max_iterations=6)
    s, e, it = ba.optimize_ba(c.state, c.obs, c.pl, max_iterations=6)
    assert it == jit
    assert abs(e - float(je)) <= 1e-9 * float(je)
    for g, w in zip(s, js):
        _close(g, w, 1e-9)


def test_ba_try_step(case29):
    """One try at the default CG tolerance (1e-6, which ba_try_step fixes)
    and lam 1e-4. CG stops short of convergence there, and on this
    ill-conditioned system the two implementations' iterates at the stop
    are 2e-6 apart: the state and the error are held to 1e-5 here, and to
    1e-9 where they converge (the steps above, optimize_ba)."""
    c = case29
    # lam as optimize_ba passes it: its compiled program is reused
    s0, e0 = jba.ba_try_step(c.jstate, c.jobs, c.jl,
                             jax.numpy.asarray(1e-4, dtype=np.float64),
                             cg_maxiter=100)
    s1, e1 = ba.ba_try_step(c.state, c.obs, c.pl, 1e-4)
    assert abs(float(e1) - float(e0)) <= 1e-5 * float(e0)
    for g, w in zip(s1, s0):
        _close(g, w, 1e-5)


def test_depth_clamp_near_camera_plane():
    """Points at depth 1e-9, -1e-9 and 1e-7 of their camera: the analytic
    linearization's clamp (|z| >= 1e-8) and the cheirality mask (depth >
    1e-6) give the rows JAX's autodiff gives, zero, and finite neighbours
    equal to it to 1e-12."""
    prob = jsyn.make_skewed_problem(num_cameras=6, num_points=40,
                                    mean_track=3.0, max_track=5, seed=2)
    first = np.unique(prob.obs_point, return_index=True)[1][:3]
    for k, z in zip(first, (1e-9, -1e-9, 1e-7)):
        c, p = prob.obs_cam[k], prob.obs_point[k]
        R, t = prob.cam_poses[c, :, :3], prob.cam_poses[c, :, 3]
        prob.points[p] = t + R @ np.array([0.3, -0.2, z])
    c = Case(prob)
    want = j_linearize(c.jstate, c.jobs)
    got = ba.linearize_ba(c.state, c.obs)
    for g, w in zip(got, want):
        g = g.numpy()
        assert np.isfinite(g).all()
        assert np.isfinite(np.asarray(w)).all()
        assert not g[first].any()
        _close(g, w, 1e-12)
