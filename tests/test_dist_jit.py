"""The JAX distributed BA and packed-BA steps (shard_map + psum) on the
8-device virtual mesh, each compiled whole with jax.jit: the checks of
test_dist_ba.py and test_dist_ba_pack.py whose cases run there eagerly
(minutes a case, so only under `-m slow`) and that the port's tests do not
make of the JAX side. Same problems, iterations and tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gtsam_personal_tpu.sfm import ba, ba_pack, synthetic
from gtsam_personal_tpu.parallel import mesh as pmesh
from gtsam_personal_tpu.parallel import dist_ba, dist_ba_pack


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return pmesh.make_mesh(8, axis="dp")


@pytest.fixture(scope="module")
def ring():
    p = synthetic.make_ring_problem(num_cameras=19, num_points=80,
                                    obs_per_point=4, seed=11)
    state, obs = ba.state_from_bal(p)
    return state, obs, p.num_cameras, p.num_points


@pytest.fixture(scope="module")
def skewed():
    p = synthetic.make_skewed_problem(num_cameras=29, num_points=300,
                                      mean_track=4.0, max_track=24, seed=5,
                                      cam_zipf=1.2)
    state, obs = ba.state_from_bal(p)
    return state, obs, p.num_cameras, p.num_points


def _lam(state, value=1e-4):
    return jnp.asarray(value, dtype=state.points.dtype)


def _dist_step(state_pad, dl, lam, mesh, cg_maxiter):
    return jax.jit(lambda s, l: dist_ba.dist_solve_ba_step(
        s, dl, l, mesh, cg_maxiter=cg_maxiter, cg_tol=1e-12))(state_pad, lam)


def test_dist_try_step_reduces_error(ring, mesh8):
    state, obs, C, P = ring
    state_pad = dist_ba.pad_cameras(state, 8)
    dl = dist_ba.build_dist_layout(obs, C, P, 8, dtype=np.float64)
    e0 = float(ba.ba_error(state_pad, obs))
    st, e1 = jax.jit(lambda s, l: dist_ba.dist_ba_try_step(
        s, obs, dl, l, mesh8, cg_maxiter=30))(state_pad, _lam(state))
    assert float(e1) < e0


def test_ownership_partitioned_layout_matches(mesh8):
    """Most landmarks exclusive to one device's cameras (small boundary):
    the boundary-only psum matches the single-device solver."""
    p = synthetic.make_skewed_problem(num_cameras=64, num_points=400,
                                      mean_track=4.0, max_track=10, seed=3)
    state, obs = ba.state_from_bal(p)
    C, P = p.num_cameras, p.num_points
    layout = ba.make_layout(obs, C, P)
    lam = _lam(state)
    xc_ref, xp_ref = ba.solve_ba_step_cm(state, obs, layout, lam,
                                         cg_maxiter=30, cg_tol=1e-12)
    state_pad = dist_ba.pad_cameras(state, 8)
    dl = dist_ba.build_dist_layout(obs, C, P, 8, dtype=np.float64)
    n, Cl, Q, T, Pd, Ps, offs = dl.dims
    assert Ps < P // 2, f"expected small boundary, got {Ps}/{P}"
    assert offs[-1] == P
    xc, xp = _dist_step(state_pad, dl, lam, mesh8, 30)
    np.testing.assert_allclose(np.asarray(xc)[:C], np.asarray(xc_ref),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(xp), np.asarray(xp_ref), atol=1e-8)


def test_partition_points_off_matches(mesh8):
    """partition_points=False (all landmarks boundary) agrees too."""
    p = synthetic.make_skewed_problem(num_cameras=24, num_points=100,
                                      mean_track=3.0, max_track=8, seed=5)
    state, obs = ba.state_from_bal(p)
    C, P = p.num_cameras, p.num_points
    state_pad = dist_ba.pad_cameras(state, 8)
    lam = _lam(state)
    dl_on = dist_ba.build_dist_layout(obs, C, P, 8, dtype=np.float64)
    dl_off = dist_ba.build_dist_layout(obs, C, P, 8, dtype=np.float64,
                                       partition_points=False)
    assert dl_off.dims[5] == P
    xc1, xp1 = _dist_step(state_pad, dl_on, lam, mesh8, 25)
    xc2, xp2 = _dist_step(state_pad, dl_off, lam, mesh8, 25)
    np.testing.assert_allclose(np.asarray(xc1), np.asarray(xc2), atol=1e-9)
    np.testing.assert_allclose(np.asarray(xp1), np.asarray(xp2), atol=1e-9)


def test_dist_pack_try_step_reduces_error(skewed, mesh8):
    state, obs, C, P = skewed
    state_pad = dist_ba.pad_cameras(state, 8)
    dpl = dist_ba_pack.build_dist_pack_layout(obs, C, P, 8, dtype=np.float64)
    e0 = float(ba.ba_error(state_pad, obs))
    st, e1 = jax.jit(lambda s, l: dist_ba_pack.dist_pack_try_step(
        s, obs, dpl, l, mesh8, cg_maxiter=20))(state_pad, _lam(state))
    assert float(e1) < e0


def test_dist_pack_lone_device(skewed):
    """n=1 degenerates to the single-device solve (no boundary points)."""
    state, obs, C, P = skewed
    mesh1 = pmesh.make_mesh(1, axis="dp")
    pl = ba_pack.make_pack_layout(obs, C, P, dtype=np.float64)
    lam = _lam(state, 3e-4)
    xc_ref, xp_ref = ba_pack.solve_ba_step_pk(state, obs, pl, lam,
                                              cg_maxiter=12, cg_tol=1e-12)
    dpl = dist_ba_pack.build_dist_pack_layout(obs, C, P, 1, dtype=np.float64)
    n, Cl, rowsC, PTC, C_slots, P_slots, Ps, _P, _cc, _pc = dpl.dims
    assert Ps == 0
    xc, xp = jax.jit(lambda s, l: dist_ba_pack.dist_pack_solve_step(
        s, dpl, l, mesh1, cg_maxiter=12, cg_tol=1e-12))(state, lam)
    np.testing.assert_allclose(np.asarray(xc)[:C], np.asarray(xc_ref),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(xp), np.asarray(xp_ref), atol=1e-8)
