"""The port's partitioned Schur solve with its fronts dealt over ranks
(gtsam_personal_tpu_torch.parallel.dist_schur) against the JAX sharded
solve on the virtual mesh and against the port's single-device
schur.solve_partitioned, in float64 on the CPU, to 1e-9 (the JAX tests'
tolerance), on the JAX tests' 96-pose graph in parts of at most 16 poses.
The port's ranks are threads (test_torch_parallel.run_ranks)."""

import jax
import numpy as np
import pytest
import torch

from gtsam_personal_tpu.linear import fm as jfm, schur as jschur
from gtsam_personal_tpu.linear.linearize import linearize as jlinearize
from gtsam_personal_tpu.parallel import mesh as jmesh
from gtsam_personal_tpu.parallel.dist_schur import (
    DistSchurPlan as JDistSchurPlan, solve_partitioned_sharded as jsharded)
from gtsam_personal_tpu_torch.linear import linearize as lin_mod, schur
from gtsam_personal_tpu_torch.parallel import dist_schur
from test_torch_graph import port_graph, port_values
from test_torch_parallel import run_ranks


class Case:
    def __init__(self):
        from __graft_entry__ import _synthetic_pose_graph
        self.jgraph, self.jinit = _synthetic_pose_graph(n_poses=96,
                                                        dtype=np.float64)
        counts = {"se2": self.jinit["se2"].shape[0]}
        self.jplan = jschur.make_plan(self.jgraph, counts, max_part_size=16)
        self.graph = port_graph(self.jgraph)
        self.plan = schur.make_plan(self.graph, counts, max_part_size=16)
        self.lin = lin_mod.linearize(self.graph, port_values(self.jinit))

    def jax(self, n, lam, fm=False):
        """The JAX sharded solve, compiled whole."""
        dplan = JDistSchurPlan(self.jplan, n)
        mesh = jmesh.make_mesh(n, axis="dp")
        lin_fn = jfm.linearize_fm if fm else jlinearize
        return jax.jit(lambda g, v: jsharded(lin_fn(g, v), dplan, mesh,
                                             lam))(self.jgraph, self.jinit)

    def dist(self, n, lam):
        def rank(m):
            return dist_schur.solve_partitioned_sharded(
                self.lin, dist_schur.DistSchurPlan(self.plan, m), m, lam)
        return run_ranks(n, rank)


@pytest.fixture(scope="module")
def case():
    return Case()


def _check(out, *refs):
    for delta in out:
        for ref in refs:
            for g in ref:
                np.testing.assert_allclose(delta[g].numpy(),
                                           np.asarray(ref[g]), atol=1e-9,
                                           rtol=0)


def test_sharded_matches_local(case):
    """8 ranks, lam 0 and 1e-3: the single-device solve, and at 1e-3 the
    JAX sharded solve."""
    assert case.plan.p > 8
    for lam in (0.0, 1e-3):
        ref = schur.solve_partitioned(case.lin, case.plan, lam)
        refs = (ref, case.jax(8, lam)) if lam else (ref,)
        _check(case.dist(8, lam), *refs)


def test_sharded_matches_local_fm(case):
    """The JAX test's feature-major linearization (a TPU layout the port
    does not take) gives the JAX sharded solve the same system: the port's
    sharded solve of its own linearization matches it."""
    ref = schur.solve_partitioned(case.lin, case.plan, 1e-4)
    _check(case.dist(8, 1e-4), ref, case.jax(8, 1e-4, fm=True))


def test_sharded_uneven_partitions(case):
    """n not dividing p: the last rank pads with empty parts, which stay
    inert."""
    ref = schur.solve_partitioned(case.lin, case.plan, 1e-4)
    for n in (3, 5):
        assert case.plan.p % n != 0
        _check(case.dist(n, 1e-4), ref, case.jax(n, 1e-4))


def test_more_ranks_than_parts(case):
    """More ranks than parts: ranks with no part of their own hold one
    empty part and still take part in the sums."""
    n = case.plan.p + 2
    _check(case.dist(n, 1e-4),
           schur.solve_partitioned(case.lin, case.plan, 1e-4))


def test_every_target_inside_its_buffer(case):
    """Each rank's slice, for several world sizes, has every scatter and
    gather target inside its buffer (checked when the slice is built); a
    dead target moved past the end of its buffer is refused."""
    for n in (1, 3, 5, 8, case.plan.p + 2):
        def rank(m):
            dp = dist_schur.DistSchurPlan(case.plan, m)
            dist_schur.check_targets(dp.rank_plan)
            return dp
        plans = run_ranks(n, rank)
        for g in case.plan.sol_maps:
            owners = torch.stack([dp.owned[g] for dp in plans]).sum(0)
            assert torch.equal(owners, torch.ones_like(owners))
        for k in ("fronts", "rhs", "ssys", "srhs"):
            got = sum(dp.gather[k].numel() for dp in plans)
            assert got == case.plan.asm[k].numel()
    rp = dist_schur.DistSchurPlan(
        case.plan, run_ranks(1, lambda m: m)[0]).rank_plan
    S = rp.S_dim
    l2g = rp.l2g.clone()
    l2g.view(-1)[0] = S + 1
    with pytest.raises(ValueError, match="l2g"):
        dist_schur.check_targets(rp._replace(l2g=l2g))
    eb = dict(rp.ea_buckets[0], tgt=rp.ea_buckets[0]["tgt"] + (S + 1) ** 2)
    with pytest.raises(ValueError, match="extend-add"):
        dist_schur.check_targets(rp._replace(ea_buckets=[eb]))


def test_collective_overhead_runs(case):
    out = run_ranks(4, lambda m: dist_schur.collective_overhead(
        case.lin, dist_schur.DistSchurPlan(case.plan, m), m, iters=1))
    t_full, t_local, frac = out[0]
    assert t_full > 0 and t_local > 0 and 0.0 <= frac < 1.0
