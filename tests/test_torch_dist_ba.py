"""The port's camera-dealt BA solve (gtsam_personal_tpu_torch.parallel.
dist_ba) against the JAX one on the 8-device virtual mesh and against the
port's camera-major single-device step (sfm/ba.py:solve_ba_step_cm), in
float64 on the CPU, with CG to 1e-12 where steps are compared. The port's
8 ranks are threads (test_torch_parallel.run_ranks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.parallel import dist_ba as jdist_ba
from gtsam_personal_tpu.parallel import mesh as jmesh
from gtsam_personal_tpu.sfm import ba as jba, synthetic as jsyn
from gtsam_personal_tpu_torch.parallel import dist_ba
from gtsam_personal_tpu_torch.sfm import ba
from test_torch_parallel import run_ranks

F64 = torch.float64


class Case:
    def __init__(self, prob):
        self.prob = prob
        self.C, self.P = prob.num_cameras, prob.num_points
        self.jstate, self.jobs = jba.state_from_bal(prob)
        self.state, self.obs = ba.state_from_bal(prob, device="cpu",
                                                 dtype=F64)
        self.layout = ba.make_layout(self.obs, self.C, self.P)

    def single(self, cg_maxiter):
        return ba.solve_ba_step_cm(self.state, self.obs, self.layout, 1e-4,
                                   cg_maxiter=cg_maxiter, cg_tol=1e-12)

    def jax_step(self, cg_maxiter):
        """The JAX distributed step, compiled whole (run eagerly, the
        shard_map body's while loop takes minutes)."""
        mesh8 = jmesh.make_mesh(8, axis="dp")
        dl = jdist_ba.build_dist_layout(self.jobs, self.C, self.P, 8,
                                        dtype=np.float64)
        return jax.jit(lambda s: jdist_ba.dist_solve_ba_step(
            s, dl, jnp.asarray(1e-4, dtype=jnp.float64), mesh8,
            cg_maxiter=cg_maxiter, cg_tol=1e-12))(
                jdist_ba.pad_cameras(self.jstate, 8))

    def dist(self, fn, **kw):
        """fn(padded state, layout, mesh) on 8 ranks."""
        def rank(m):
            dl = dist_ba.build_dist_layout(self.obs, self.C, self.P, m, **kw)
            return fn(dist_ba.pad_cameras(self.state, m.size), dl, m)
        return run_ranks(8, rank)

    def dist_step(self, cg_maxiter, **kw):
        return self.dist(lambda s, dl, m: dist_ba.dist_solve_ba_step(
            s, dl, 1e-4, m, cg_maxiter=cg_maxiter, cg_tol=1e-12), **kw)


@pytest.fixture(scope="module")
def ring():
    return Case(jsyn.make_ring_problem(num_cameras=19, num_points=80,
                                       obs_per_point=4, seed=11))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


def test_dist_solve_matches_cm(ring):
    """The 19-camera ring on 8 ranks: the JAX distributed step and the
    port's camera-major step, to 1e-8; padded cameras stay fixed."""
    xc_ref, xp_ref = ring.single(30)
    jxc, jxp = ring.jax_step(30)
    out = ring.dist_step(30)
    xc, xp = out[0]
    C = ring.C
    _close(xc[:C], xc_ref, 1e-8)
    _close(xp, xp_ref, 1e-8)
    _close(xc[:C], np.asarray(jxc)[:C], 1e-8)
    _close(xp, jxp, 1e-8)
    _close(xc[C:], 0.0, 1e-12)
    for oc, op in out[1:]:
        assert torch.equal(oc, xc) and torch.equal(op, xp)


def test_dist_try_step_reduces_error(ring):
    e0 = float(ba.ba_error(ring.state, ring.obs))
    for _, e1 in ring.dist(lambda s, dl, m: dist_ba.dist_ba_try_step(
            s, ring.obs, dl, 1e-4, m, cg_maxiter=30)):
        assert float(e1) < e0


def test_collective_overhead_runs(ring):
    out = ring.dist(lambda s, dl, m: dist_ba.collective_overhead(
        s, dl, m, cg_maxiter=5, iters=2))
    t_full, t_local, frac = out[0]
    assert t_full > 0 and t_local > 0 and 0.0 <= frac < 1.0


def test_ownership_partitioned_layout_matches():
    """Sequential covisibility: most landmarks are seen from one rank's
    cameras only (a small boundary), and the boundary-only sums still give
    the single-device step. Every rank's slots are the boundary prefix,
    then its own landmarks; together the ranks own every landmark once.

    CG does not reach 1e-12 on this system: it stops at its cap of 30, and
    there any two implementations' iterates differ by their rounding
    amplified by the system's condition (the port's and the JAX single-
    device steps by 3.4e-7, 4e-9 of the largest entry; at 60 iterations
    by 0.1). So the step (xc and xp) is held to 1e-8 of its largest entry
    here, and to 1e-8 absolute where CG converges
    (test_dist_solve_matches_cm)."""
    case = Case(jsyn.make_skewed_problem(num_cameras=64, num_points=400,
                                         mean_track=4.0, max_track=10,
                                         seed=3))
    xc_ref, xp_ref = case.single(30)
    layouts = case.dist(lambda s, dl, m: dl)
    Ps = layouts[0].Ps
    assert Ps < case.P // 2, f"expected a small boundary, got {Ps}/{case.P}"
    owned = []
    for dl in layouts:
        assert torch.equal(dl.pt_ids[:Ps], layouts[0].pt_ids[:Ps])
        assert torch.equal(dl.b_slot, torch.arange(Ps))
        assert torch.equal(dl.b_idx, torch.arange(Ps))
        assert int(dl.own_slot.max()) < dl.pl.P
        owned.append(dl.pt_ids[dl.own_slot])
    assert sorted(torch.cat(owned).tolist()) == list(range(case.P))
    xc, xp = case.dist_step(30)[0]
    scale = max(float(xc_ref.abs().max()), float(xp_ref.abs().max()))
    _close(xc[:case.C], xc_ref, 1e-8 * scale)
    _close(xp, xp_ref, 1e-8 * scale)


def test_partition_points_off_matches():
    """partition_points=False (every landmark a boundary one, Ps = P)
    gives the same step as the partitioned layout and as the port's
    single-device step (the JAX distributed step is held to the port's in
    test_dist_solve_matches_cm). CG stops at its cap of 25 here, as in
    test_ownership_partitioned_layout_matches, and the layouts' sums over
    the ranks add in other orders (gloo's ring reduces each element in an
    order set by the tensor's length): the steps are held to 1e-8 of their
    largest entry (5e-9 seen)."""
    case = Case(jsyn.make_skewed_problem(num_cameras=24, num_points=100,
                                         mean_track=3.0, max_track=8,
                                         seed=5))
    off = case.dist(lambda s, dl, m: dl, partition_points=False)[0]
    assert off.Ps == case.P
    xc1, xp1 = case.dist_step(25)[0]
    xc2, xp2 = case.dist_step(25, partition_points=False)[0]
    xc0, xp0 = case.single(25)
    scale = max(float(xc1.abs().max()), float(xp1.abs().max()))
    for xc, xp in ((xc2, xp2), (xc0, xp0)):
        _close(xc1[:case.C], xc[:case.C], 1e-8 * scale)
        _close(xp1, xp, 1e-8 * scale)
