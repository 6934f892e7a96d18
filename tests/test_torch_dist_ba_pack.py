"""The port's distributed flagship BA engine
(gtsam_personal_tpu_torch.parallel.dist_ba_pack) against the JAX one on the
8-device virtual mesh and against the port's single-device engine
(sfm/ba_pack.py), in float64 on the CPU, on the JAX tests' 29-camera skewed
problem. The port's 8 ranks are threads (test_torch_parallel.run_ranks).
The JAX results are computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.parallel import dist_ba as jdist_ba
from gtsam_personal_tpu.parallel import dist_ba_pack as jdist_pack
from gtsam_personal_tpu.parallel import mesh as jmesh
from gtsam_personal_tpu.sfm import ba as jba, synthetic as jsyn
from gtsam_personal_tpu_torch.parallel import dist_ba, dist_ba_pack
from gtsam_personal_tpu_torch.parallel import mesh as pmesh
from gtsam_personal_tpu_torch.sfm import ba, ba_pack
from test_torch_parallel import run_ranks

F64 = torch.float64


class Case:
    def __init__(self):
        # skewed: power-law tracks and Zipf camera counts (the JAX test's)
        self.prob = jsyn.make_skewed_problem(num_cameras=29, num_points=300,
                                             mean_track=4.0, max_track=24,
                                             seed=5, cam_zipf=1.2)
        self.C, self.P = self.prob.num_cameras, self.prob.num_points
        self.jstate, self.jobs = jba.state_from_bal(self.prob)
        self.state, self.obs = ba.state_from_bal(self.prob, device="cpu",
                                                 dtype=F64)
        self.pl = ba_pack.make_pack_layout(self.obs, self.C, self.P)

    def dist(self, n, fn, balanced=True):
        """fn(padded state, layout, mesh) on n ranks."""
        def rank(m):
            dpl = dist_ba_pack.build_dist_pack_layout(
                self.obs, self.C, self.P, m, balanced=balanced)
            return fn(dist_ba.pad_cameras(self.state, n), dpl, m)
        return run_ranks(n, rank)


@pytest.fixture(scope="module")
def case():
    return Case()


@pytest.fixture(scope="module")
def jax8(case):
    """The JAX tests' distributed solve and LM run on the 8-device mesh."""
    mesh8 = jmesh.make_mesh(8, axis="dp")
    state_pad = jdist_ba.pad_cameras(case.jstate, 8)
    dpl = jdist_pack.build_dist_pack_layout(case.jobs, case.C, case.P, 8,
                                            dtype=np.float64)
    # compiled whole: run eagerly, the shard_map bodies take minutes
    step = jax.jit(lambda s: jdist_pack.dist_pack_solve_step(
        s, dpl, jnp.asarray(1e-4, dtype=jnp.float64), mesh8, cg_maxiter=20,
        cg_tol=1e-12))(state_pad)
    err0 = jax.jit(lambda s: jdist_pack.dist_pack_error(s, dpl, mesh8))(
        state_pad)
    lm = jax.jit(lambda s, e: jdist_pack.dist_pack_lm_run(
        s, dpl, jnp.asarray(1e-3, dtype=jnp.float64), e, n_iters=5,
        mesh=mesh8, cg_maxiter=8))(state_pad, err0)
    return {"step": step, "err0": err0, "lm": lm, "Ps": dpl.dims[6]}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_dist_pack_solve_matches_single_pack(case, jax8):
    """8 ranks, CG to 1e-12: the JAX distributed step and the port's
    single-device step, to 1e-8; the padded cameras' steps are 0 and every
    rank returns the same step."""
    xc_ref, xp_ref = ba_pack.solve_ba_step_pk(case.state, case.obs, case.pl,
                                              1e-4, cg_maxiter=20,
                                              cg_tol=1e-12)
    jxc, jxp = jax8["step"]
    out = case.dist(8, lambda s, dpl, m: dist_ba_pack.dist_pack_solve_step(
        s, dpl, 1e-4, m, cg_maxiter=20, cg_tol=1e-12))
    xc, xp = out[0]
    _close(xc[:case.C], xc_ref, 1e-8)
    _close(xp, xp_ref, 1e-8)
    _close(xc[:case.C], np.asarray(jxc)[:case.C], 1e-8)
    _close(xp, jxp, 1e-8)
    _close(xc[case.C:], 0.0, 1e-12)
    for oc, op in out[1:]:
        assert torch.equal(oc, xc) and torch.equal(op, xp)


def test_dist_pack_try_step_reduces_error(case):
    e0 = float(ba.ba_error(case.state, case.obs))
    out = case.dist(8, lambda s, dpl, m: dist_ba_pack.dist_pack_try_step(
        s, case.obs, dpl, 1e-4, m, cg_maxiter=20))
    for _, e1 in out:
        assert float(e1) < e0


def test_dist_pack_lone_device(case):
    """A world of one: no boundary landmarks (Ps == 0), and the step is the
    single-device one."""
    m = pmesh.make_mesh(None, device="cpu")
    dpl = dist_ba_pack.build_dist_pack_layout(case.obs, case.C, case.P, m)
    assert dpl.Ps == 0 and dpl.b_slot.numel() == 0
    xc_ref, xp_ref = ba_pack.solve_ba_step_pk(case.state, case.obs, case.pl,
                                              3e-4, cg_maxiter=12,
                                              cg_tol=1e-12)
    xc, xp = dist_ba_pack.dist_pack_solve_step(case.state, dpl, 3e-4, m,
                                               cg_maxiter=12, cg_tol=1e-12)
    _close(xc[:case.C], xc_ref, 1e-8)
    _close(xp, xp_ref, 1e-8)


@pytest.fixture(scope="module")
def lm_runs(case):
    err0 = ba_pack.ba_error_pk(case.state, case.obs, case.pl)
    single = ba_pack.ba_lm_run_pk(case.state, case.obs, case.pl, 1e-3, err0,
                                  n_iters=5, cg_maxiter=8)

    def fn(s, dpl, m):
        e0 = dist_ba_pack.dist_pack_error(s, dpl, m)
        return e0, dist_ba_pack.dist_pack_lm_run(s, dpl, 1e-3, e0, n_iters=5,
                                                 mesh=m, cg_maxiter=8)
    return err0, single, case.dist(8, fn)


def test_dist_pack_lm_run_matches_single(case, jax8, lm_runs):
    """The whole distributed LM loop (accept/reject, lambda, reject-try
    reuse) on 8 ranks tracks the port's ba_lm_run_pk and the JAX
    distributed run: error 1e-8 relative, lambda 1e-12, state 1e-8."""
    err0, (st_ref, lam_ref, err_ref), out = lm_runs
    jst, jlam, jerr = jax8["lm"]
    C = case.C
    for e0, (st, lam, err) in out:
        np.testing.assert_allclose(float(e0), float(err0), rtol=1e-10)
        np.testing.assert_allclose(float(e0), float(jax8["err0"]),
                                   rtol=1e-10)
        assert float(err) < float(err0)
        for want_err, want_lam, want in ((err_ref, lam_ref, st_ref),
                                         (jerr, jlam, jst)):
            np.testing.assert_allclose(float(err), float(want_err),
                                       rtol=1e-8)
            np.testing.assert_allclose(float(lam), float(want_lam),
                                       rtol=1e-12)
            _close(st.cam_poses[:C], np.asarray(want.cam_poses)[:C], 1e-8)
            _close(st.cam_cals[:C], np.asarray(want.cam_cals)[:C], 1e-8)
            _close(st.points, want.points, 1e-8)


def test_dist_pack_padding_bounded(case):
    """The flat layout stores each observation once on each side: the
    padding waste summed over the ranks is (1.0, 1.0) under either dealing,
    and balanced dealing keeps the ranks' rows within one camera's count."""
    counts = np.bincount(case.prob.obs_cam, minlength=case.C)
    for balanced in (True, False):
        dpl = case.dist(8, lambda s, d, m: d, balanced)[0]
        assert dist_ba_pack.padding_waste(dpl, case.pl.M) == (1.0, 1.0)
        assert sum(dpl.rows) == case.pl.M
    bal = case.dist(8, lambda s, d, m: d.rows)[0]
    assert max(bal) - min(bal) <= counts.max()


def test_layout_maps_inside_their_buffers(case, jax8):
    """Every rank's maps, under both dealings: local cameras are the
    state's rows once each, boundary and owned slots lie in the rank's
    slots, boundary indices in [0, Ps), every landmark seen is owned by
    exactly one rank, and the boundary is the JAX layout's."""
    seen = np.unique(case.prob.obs_point)
    for balanced in (True, False):
        out = case.dist(8, lambda s, d, m: d, balanced)
        Cl, Ps = out[0].Cl, out[0].Ps
        rows = torch.cat([d.cam_rows for d in out])
        assert sorted(rows.tolist()) == list(range(8 * Cl))
        owned = []
        for d in out:
            slots = d.pl.P
            assert d.Ps == Ps and d.pt_ids.numel() == slots
            for t, size in ((d.b_slot, slots), (d.own_slot, slots),
                            (d.b_idx, Ps), (d.pl.pt_of, slots),
                            (d.pl.cam_of, Cl)):
                assert t.numel() == 0 or (0 <= int(t.min())
                                          and int(t.max()) < size)
            owned.append(d.pt_ids[d.own_slot])
        owned = torch.cat(owned)
        assert owned.numel() == seen.size
        assert np.array_equal(np.sort(owned.numpy()), seen)
        if balanced:
            assert Ps == jax8["Ps"]


def test_skip_collectives(case):
    """Without its all-reduces a rank solves only its own share: a finite
    step that differs from the true one (the measure's second run)."""
    def fn(s, dpl, m):
        full = dist_ba_pack.dist_pack_solve_step(s, dpl, 1e-4, m,
                                                 cg_maxiter=5)
        local = dist_ba_pack.dist_pack_solve_step(s, dpl, 1e-4, m,
                                                  cg_maxiter=5,
                                                  skip_collectives=True)
        return full, local
    (xc, xp), (lc, lp) = case.dist(4, fn)[1]
    assert lc.shape == xc.shape and lp.shape == xp.shape
    assert torch.isfinite(lc).all() and torch.isfinite(lp).all()
    assert float((lc - xc).abs().max()) > 1e-6


def test_collective_overhead_runs(case):
    out = case.dist(8, lambda s, dpl, m: dist_ba_pack.collective_overhead(
        s, dpl, m, cg_maxiter=5, iters=1))
    t_full, t_local, frac = out[0]
    assert t_full > 0 and t_local > 0 and 0.0 <= frac < 1.0
    assert all(o == out[0] for o in out)
