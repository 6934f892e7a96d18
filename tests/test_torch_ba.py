"""The port's BA engine (gtsam_personal_tpu_torch.sfm.ba_pack) against the
JAX packed engine (gtsam_personal_tpu.sfm.ba_pack), in float64 on the CPU.

The same seeded problems go through both; the JAX results are built once
per module. Per-observation outputs are compared in observation order
(each layout maps its rows back), per-entity outputs in entity order."""

import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_personal_tpu_torch
from gtsam_personal_tpu.sfm import ba as jba, ba_pack as jbp, synthetic as jsyn
from gtsam_personal_tpu_torch.sfm import ba, ba_pack

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
# whole-function compiles: faster here than JAX's op-by-op dispatch
j_linearize = jax.jit(jbp.linearize_ba_pk, static_argnames=("robust",))
j_error = jax.jit(jbp.ba_error_pk, static_argnames=("robust",))
j_solve = jax.jit(jbp.solve_ba_step_pk, static_argnames=("robust",))
j_reduce = jax.jit(lambda pl, lin: jbp._reduce_cache(
    pl, lin, jbp._relayout_pm(pl, lin[0], lin[2])))


class Case:
    """One problem in both packages: JAX state/obs/PackLayout, port
    state/obs/BALayout."""

    def __init__(self, prob, uv=None):
        if uv is not None:
            prob.obs_uv = uv
        C, P = prob.num_cameras, prob.num_points
        self.C, self.P = C, P
        self.jstate, self.jobs = jba.state_from_bal(prob)
        self.jpl = jbp.make_pack_layout(self.jobs, C, P, dtype=np.float64)
        self.state = ba.state_from_numpy(*map(np.asarray, self.jstate),
                                         device="cpu", dtype=F64)
        self.obs = ba.observations_from_numpy(*map(np.asarray, self.jobs),
                                              device="cpu", dtype=F64)
        self.pl = ba_pack.make_pack_layout(self.obs, C, P)

    def jax_rows_to_obs(self, x):
        """JAX per-slot [..., S] -> observation order [..., M]."""
        g = np.asarray(self.jpl.g_cam)
        live = g < self.jpl.M
        out = np.empty(np.shape(x)[:-1] + (self.jpl.M,))
        out[..., g[live]] = np.asarray(x)[..., live]
        return out

    def rows_to_obs(self, x):
        """Port per-row [..., M] -> observation order [..., M]."""
        out = torch.empty_like(x)
        out[..., self.pl.obs_of_slot] = x
        return out.numpy()


def _skewed24(seed):
    return jsyn.make_skewed_problem(num_cameras=24, num_points=300,
                                    mean_track=4.0, max_track=12, seed=seed,
                                    cam_zipf=1.2)


@pytest.fixture(scope="module")
def case29():
    """29 cameras: both stacked and wrapped classes in the JAX layout."""
    return Case(jsyn.make_skewed_problem(num_cameras=29, num_points=300,
                                         mean_track=4.0, max_track=24, seed=5,
                                         cam_zipf=1.2))


# --- the port stands alone --------------------------------------------------

def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without jax (in a
    fresh interpreter: this one has jax loaded by the test setup)."""
    mods = [m.name for m in pkgutil.walk_packages(
        gtsam_personal_tpu_torch.__path__, "gtsam_personal_tpu_torch.")]
    assert {"gtsam_personal_tpu_torch.sfm.ba_pack",
            "gtsam_personal_tpu_torch.nonlinear.isam2",
            "gtsam_personal_tpu_torch.linear.marginal",
            "gtsam_personal_tpu_torch.ops.chain",
            "gtsam_personal_tpu_torch.tools.profile_isam2",
            "gtsam_personal_tpu_torch.slam.dataset",
            "gtsam_personal_tpu_torch.slam.initialize",
            "gtsam_personal_tpu_torch.slam.unstable",
            "gtsam_personal_tpu_torch.geometry.extra",
            "gtsam_personal_tpu_torch.geometry.fundamental",
            "gtsam_personal_tpu_torch.tools.pose_graph_g2o",
            "gtsam_personal_tpu_torch.tools.factor_samples",
            "gtsam_personal_tpu_torch.utils.serialization",
            "gtsam_personal_tpu_torch.navigation.navstate",
            "gtsam_personal_tpu_torch.navigation.preintegration",
            "gtsam_personal_tpu_torch.navigation.factors",
            "gtsam_personal_tpu_torch.navigation.scenario",
            "gtsam_personal_tpu_torch.navigation.geodetic",
            "gtsam_personal_tpu_torch.navigation.dynamics",
            "gtsam_personal_tpu_torch.ops.preintegration",
            "gtsam_personal_tpu_torch.geometry.triangulation",
            "gtsam_personal_tpu_torch.sfm.smart",
            "gtsam_personal_tpu_torch.tools.imu_gps_vio",
            "gtsam_personal_tpu_torch.tools.imu_factors",
            "gtsam_personal_tpu_torch.tools.isam2_smart_factor",
            "gtsam_personal_tpu_torch.sfm.ba",
            "gtsam_personal_tpu_torch.core.keys",
            "gtsam_personal_tpu_torch.inference.symbolic",
            "gtsam_personal_tpu_torch.discrete.discrete",
            "gtsam_personal_tpu_torch.discrete.csp",
            "gtsam_personal_tpu_torch.hybrid.hybrid",
            "gtsam_personal_tpu_torch.basis.chebyshev",
            "gtsam_personal_tpu_torch.io.qps",
            "gtsam_personal_tpu_torch.utils.timing",
            "gtsam_personal_tpu_torch.utils.debug",
            "gtsam_personal_tpu_torch.utils.dot",
            "gtsam_personal_tpu_torch.tools.sfm_example_bal",
            "gtsam_personal_tpu_torch.tools.discrete_examples",
            "gtsam_personal_tpu_torch.tools.hybrid_city10000",
            "gtsam_personal_tpu_torch.parallel.bootstrap",
            "gtsam_personal_tpu_torch.parallel.mesh",
            "gtsam_personal_tpu_torch.parallel.dist_ba",
            "gtsam_personal_tpu_torch.parallel.dist_ba_pack",
            "gtsam_personal_tpu_torch.parallel.ba_sharded",
            "gtsam_personal_tpu_torch.parallel.dist_schur",
            "gtsam_personal_tpu_torch.tools.stereo_vo_large",
            "gtsam_personal_tpu_torch.tools.victoria_park",
            "gtsam_personal_tpu_torch.tools.range_isam_plaza2",
            "gtsam_personal_tpu_torch.tools.visual_isam2",
            "gtsam_personal_tpu_torch.tools.pose2_m3500",
            "gtsam_personal_tpu_torch.tools.view_graph",
            "gtsam_personal_tpu_torch.tools.parity_suite"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods + ['chip_smoke']!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'gtsam_personal_tpu.'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_config_tf32_off_and_device(monkeypatch):
    from gtsam_personal_tpu_torch import config
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert config.device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        config.device("cuda")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_card(where, tmp_path):
    """Without a card, or without the package beside it, chip_smoke.py exits
    non-zero and prints no result line."""
    if where == "repo" and torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    cwd = REPO if where == "repo" else tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# --- data and layout --------------------------------------------------------

def test_state_roundtrip(case29):
    back = ba.state_to_numpy(case29.state)
    for a, b in zip(back, case29.jstate):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert case29.obs.cam.dtype == torch.int64
    np.testing.assert_array_equal(case29.obs.uv.numpy(),
                                  np.asarray(case29.jobs.uv))


def test_layout_invariants(case29):
    pl, obs = case29.pl, case29.obs
    M = obs.cam.shape[0]
    assert (pl.C, pl.P, pl.M) == (case29.C, case29.P, M)
    assert torch.equal(torch.sort(pl.obs_of_slot).values, torch.arange(M))
    assert torch.equal(pl.cam_of, obs.cam[pl.obs_of_slot])
    assert torch.equal(pl.pt_of, obs.point[pl.obs_of_slot])
    assert torch.equal(pl.uv_cm, obs.uv[pl.obs_of_slot].T)
    assert bool((pl.cam_of[1:] >= pl.cam_of[:-1]).all())      # camera-major
    for c in range(pl.C):
        assert bool((pl.cam_of[pl.cam_ptr[c]:pl.cam_ptr[c + 1]] == c).all())
    assert torch.equal(pl.pt_ptr.diff(), torch.bincount(obs.point,
                                                        minlength=pl.P))


# --- linearize / error / reductions -----------------------------------------

@pytest.mark.parametrize("which", ["skewed24", "skewed29"])
def test_linearize_matches(which, case29):
    case = Case(_skewed24(2)) if which == "skewed24" else case29
    ref = j_linearize(case.jstate, case.jobs, case.jpl)
    got = ba_pack.linearize_ba_pk(case.state, case.obs, case.pl)
    for name, a, b in zip(("r", "Jc", "Jp"), got, ref):
        np.testing.assert_allclose(case.rows_to_obs(a),
                                   case.jax_rows_to_obs(b), rtol=1e-10,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("which", ["skewed24", "ring16"])
def test_error_matches(which):
    prob = (_skewed24(0) if which == "skewed24" else
            jsyn.make_ring_problem(num_cameras=16, num_points=200,
                                   obs_per_point=4, seed=1))
    case = Case(prob)
    ref = float(j_error(case.jstate, case.jobs, case.jpl))
    got = ba_pack.ba_error_pk(case.state, case.obs, case.pl)
    assert got.dim() == 0 and got.dtype == F64
    assert float(got) == pytest.approx(ref, rel=1e-12)


def test_reduce_cache_matches(case29):
    """Each output entry is a sum over rows, held to rtol 1e-10 of the sum
    of its terms' magnitudes, the forward-error bound of a sum: an entry
    of Hcc cancels to 3e-14 from terms whose magnitudes sum to 9e4, and
    there the last rounding of the summands (XLA may contract a
    multiply-add) decides its digits, not the algorithm. The largest
    deviation seen is 4e-15 of that scale."""
    jl = j_linearize(case29.jstate, case29.jobs, case29.jpl)
    jpl = case29.jpl
    ref = j_reduce(jpl, jl)
    lin = ba_pack.linearize_ba_pk(case29.state, case29.obs, case29.pl)
    got = ba_pack._reduce_cache(case29.pl, lin)
    scale = ba_pack._reduce_cache(case29.pl, [x.abs() for x in lin])
    cams, pts = np.asarray(jpl.cam_orig2slot), np.asarray(jpl.pt_orig2slot)
    for name, a, b, s, order in zip(("Hpp_raw", "gc", "gp", "Hcc"), got,
                                    ref, scale, (pts, cams, pts, cams)):
        dev = np.abs(a.numpy() - np.asarray(b)[:, order])
        assert np.all(dev <= 1e-10 * s.numpy()), (name, dev.max())


# --- the step ---------------------------------------------------------------

def test_solve_step_cg2(case29):
    ref = j_solve(case29.jstate, case29.jobs, case29.jpl,
                  jnp.asarray(1e-4), cg_maxiter=2, cg_tol=1e-6)
    got = ba_pack.solve_ba_step_pk(case29.state, case29.obs, case29.pl,
                                   1e-4, cg_maxiter=2)
    assert got[0].shape == (case29.C, 9) and got[1].shape == (case29.P, 3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9)


def test_solve_step_converged(case29):
    """cg_maxiter=200, cg_tol=1e-12 at lam = 1: converged, the step agrees
    to atol 1e-8. Not at lam = 1e-4: there the Schur system is so
    ill-conditioned that 200 iterations do not converge, and a 1e-15
    relative change of the input points moves the answer by 2e-6 in either
    package, so no two implementations can agree to 1e-8."""
    ref = j_solve(case29.jstate, case29.jobs, case29.jpl,
                  jnp.asarray(1.0), cg_maxiter=200, cg_tol=1e-12)
    got = ba_pack.solve_ba_step_pk(case29.state, case29.obs, case29.pl, 1.0,
                                   cg_maxiter=200, cg_tol=1e-12)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-8)


# --- the LM loop ------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_runs():
    """5 LM iterations, cg 8, lam0 1e-3 on the 24-camera problem, seed 3
    (tests/test_ba_pack.py:95), in both packages."""
    case = Case(_skewed24(3))
    e0 = j_error(case.jstate, case.jobs, case.jpl)
    ref = jbp.ba_lm_run_pk(case.jstate, case.jobs, case.jpl,
                           jnp.asarray(1e-3), e0, n_iters=5, cg_maxiter=8)
    got = ba_pack.ba_lm_run_pk(
        case.state, case.obs, case.pl, 1e-3,
        ba_pack.ba_error_pk(case.state, case.obs, case.pl), n_iters=5,
        cg_maxiter=8)
    return case, ref, got, float(e0)


def test_lm_run_error(lm_runs):
    _, (_, _, e_ref), (_, _, e), e0 = lm_runs
    assert e.dim() == 0
    assert float(e) < 0.2 * e0
    assert float(e) == pytest.approx(float(e_ref), rel=1e-9)


def test_lm_run_lambda(lm_runs):
    """lam0 1e-3 ends at 2.5e-4 through both accepts (x0.5) and a reject
    (x4); the port takes the same decisions."""
    _, (_, lam_ref, _), (_, lam, _), _ = lm_runs
    assert lam.dim() == 0
    assert float(lam) == float(lam_ref)


def test_lm_run_state(lm_runs):
    _, (st_ref, _, _), (st, _, _), _ = lm_runs
    for a, b in zip(st, st_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)


def test_lm_run_equals_iterated_lm_iter(lm_runs):
    """The cached-linearization loop gives what one fresh linearization per
    iteration gives (a rejected try leaves the state bit-identical)."""
    case, _, (st, lam, err), _ = lm_runs
    s, l, e = case.state, 1e-3, ba_pack.ba_error_pk(case.state, case.obs,
                                                     case.pl)
    for _ in range(5):
        s, l, e = ba_pack.ba_lm_iter_pk(s, case.obs, case.pl, l, e,
                                        cg_maxiter=8)
    assert float(l) == float(lam) and float(e) == float(err)
    for a, b in zip(s, st):
        assert torch.equal(a, b)


def test_optimize_ba_pk_reduces_error():
    case = Case(jsyn.make_ring_problem(num_cameras=16, num_points=200,
                                       obs_per_point=4, seed=1))
    e0 = float(ba_pack.ba_error_pk(case.state, case.obs, case.pl))
    _, err, iters = ba_pack.optimize_ba_pk(case.state, case.obs, case.pl,
                                           max_iterations=10, chunk=5,
                                           cg_maxiter=8)
    assert 0 < iters <= 10 and err < 0.1 * e0


# --- robust (Huber) ---------------------------------------------------------

@pytest.fixture(scope="module")
def huber_case():
    """5% gross outliers on the 24-camera problem, seed 7
    (tests/test_ba_pack.py:125)."""
    prob = _skewed24(7)
    rng = np.random.default_rng(0)
    uv = prob.obs_uv.copy()
    n_out = max(4, uv.shape[0] // 20)
    sel = rng.choice(uv.shape[0], size=n_out, replace=False)
    uv[sel] += rng.normal(scale=80.0, size=(n_out, 2))
    return Case(prob, uv=uv)


def test_huber_linearize_rows(huber_case):
    c = huber_case
    ref = j_linearize(c.jstate, c.jobs, c.jpl, robust="huber",
                      robust_k=3.0)
    got = ba_pack.linearize_ba_pk(c.state, c.obs, c.pl, robust="huber",
                                  robust_k=3.0)
    for name, a, b in zip(("r", "Jc", "Jp"), got, ref):
        np.testing.assert_allclose(c.rows_to_obs(a), c.jax_rows_to_obs(b),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_huber_lm_error(huber_case):
    c = huber_case
    e0 = j_error(c.jstate, c.jobs, c.jpl, "huber", 3.0)
    _, _, e_ref = jbp.ba_lm_run_pk(c.jstate, c.jobs, c.jpl,
                                   jnp.asarray(1e-3), e0, n_iters=15,
                                   cg_maxiter=8, robust="huber", robust_k=3.0)
    t0 = ba_pack.ba_error_pk(c.state, c.obs, c.pl, "huber", 3.0)
    assert float(t0) == pytest.approx(float(e0), rel=1e-12)
    _, _, e = ba_pack.ba_lm_run_pk(c.state, c.obs, c.pl, 1e-3, t0,
                                   n_iters=15, cg_maxiter=8, robust="huber",
                                   robust_k=3.0)
    assert float(e) < float(t0)
    assert float(e) == pytest.approx(float(e_ref), rel=1e-8)
