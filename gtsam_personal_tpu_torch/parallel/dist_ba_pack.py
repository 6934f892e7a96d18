"""The flagship BA engine distributed: the whole LM loop over ranks.

JAX counterpart: gtsam_personal_tpu/parallel/dist_ba_pack.py
(DistPackLayout, build_dist_pack_layout, padding_waste, _device_kernels,
dist_pack_solve_step, dist_pack_error, dist_pack_lm_run,
dist_pack_try_step, collective_overhead). The JAX module shares one TPU
tile geometry (stack/wrap classes) over all devices, because one
`shard_map` program must serve them all. Each rank here runs its own
program, so it keeps the flat camera-sorted `sfm/ba_layout.py:BALayout` of
its own observations over the landmarks its cameras see, and there is no
shared geometry to build (parallel/dist_ba.py:build_rank_layout).

The dealing is the JAX module's. balanced=True (the default) deals cameras
round-robin by descending observation count, so the ranks' row counts
differ by at most one camera's; balanced=False deals them contiguously.
All of a camera's observations live on its rank. Landmarks seen from more
than one rank take the ascending global order, and their owner is the
lowest rank that sees them.

The all-reduces are the JAX module's psums:
  - the boundary rows of [Hpp_raw; gp] once a linearization, inside the
    reductions that a rejected try reuses;
  - one [3, Ps] boundary all-reduce a Schur matvec;
  - the PCG dot products;
  - the error;
  - the rebuild of the whole state from the ranks' disjoint camera rows and
    owned landmark steps (one all-reduce).
`dist_pack_lm_run` keeps ba_pack.ba_lm_run_pk's schedule: CG runs
`cg_maxiter` masked iterations, the loop relinearizes only after an accept,
lambda is halved or quadrupled inside [lam_lo, lam_hi]. The accept flag
comes from the summed error, the same on every rank, so every rank takes
the same branch; reading it is the loop's one host read an iteration.
"""

import numpy as np
import torch

from gtsam_personal_tpu_torch.parallel import dist_ba
from gtsam_personal_tpu_torch.parallel.dist_ba import DistBALayout
from gtsam_personal_tpu_torch.parallel.mesh import Mesh
from gtsam_personal_tpu_torch.sfm import ba

# One rank's share, as in parallel/dist_ba.py; the JAX module's per-device
# tile tables have no counterpart.
DistPackLayout = DistBALayout


def deal_balanced(counts, n: int):
    """(rank of each camera, its index on the rank, Cl): cameras dealt
    round-robin by descending observation count (stable)."""
    C = counts.shape[0]
    order = np.argsort(-counts, kind="stable")
    dev = np.empty(C, dtype=np.int64)
    loc = np.empty(C, dtype=np.int64)
    dev[order] = np.arange(C) % n
    loc[order] = np.arange(C) // n
    return dev, loc, -(-C // n)


def build_dist_pack_layout(obs: ba.BAObservations, C: int, P: int,
                           mesh: Mesh,
                           balanced: bool = True) -> DistPackLayout:
    """This rank's layout: its cameras' rows over the landmarks they see."""
    if balanced:
        counts = np.bincount(obs.cam.cpu().numpy(), minlength=C)
        dev, loc, Cl = deal_balanced(counts, mesh.size)
    else:
        dev, loc, Cl = dist_ba.deal_contiguous(C, mesh.size)
    return dist_ba.build_rank_layout(obs, C, P, mesh, dev, loc, Cl,
                                     prefix=False)


def padding_waste(dpl: DistPackLayout, M: int):
    """(camera side, landmark side): rows stored over live observations,
    summed over the ranks, the JAX module's measure of its tiles' padding.
    The flat layout stores each observation once on each side and nothing
    else, so both are 1.0."""
    stored = sum(dpl.rows)
    return stored / M, stored / M


def dist_pack_solve_step(state_pad: ba.BAState, dpl: DistPackLayout, lam,
                         mesh: Mesh, cg_maxiter=25, cg_tol=1e-6,
                         skip_collectives: bool = False):
    """Camera-dealt implicit-Schur solve, `cg_maxiter` masked CG iterations
    (the JAX while_loop with its tolerance exit gives the same result).
    Returns (xc [n Cl, 9], xp [P, 3]), the same on every rank."""
    mesh = dist_ba.rank_mesh(state_pad, dpl, mesh, skip_collectives)
    xc_l, xp_l = dist_ba.solve_local(state_pad, dpl, lam, mesh, cg_maxiter,
                                     cg_tol, check_every=None)
    return dist_ba.assemble_step(xc_l, xp_l, dpl, mesh)


def dist_pack_error(state_pad: ba.BAState, dpl: DistPackLayout, mesh: Mesh):
    """The total BA error through the ranks' rows (one scalar all-reduce),
    a 0-d tensor."""
    dist_ba.rank_mesh(state_pad, dpl, mesh)
    return dist_ba.dist_error(state_pad, dpl, mesh)


def dist_pack_lm_run(state_pad: ba.BAState, dpl: DistPackLayout, lam, err,
                     n_iters: int, mesh: Mesh, cg_maxiter=10, cg_tol=1e-6,
                     lam_lo=1e-6, lam_hi=1e3):
    """`n_iters` LM iterations of the flagship engine, distributed: the
    twin of ba_pack.ba_lm_run_pk. `err` must come from dist_pack_error.
    Returns (state, lam, err), the same on every rank, lam and err 0-d
    tensors."""
    mesh = dist_ba.rank_mesh(state_pad, dpl, mesh)
    state = state_pad
    like = state.points
    lam = torch.as_tensor(lam, dtype=like.dtype, device=like.device)
    err = torch.as_tensor(err, dtype=like.dtype, device=like.device)
    sums = dist_ba.RankSums(dpl, mesh)
    need_relin = True
    for i in range(n_iters):
        if need_relin:
            lin = ba.linearize_ba_cm(dist_ba.local_state(state, dpl), None,
                                     dpl.pl)
            red = ba._reduce_cache(dpl.pl, lin, sums)
        xc_l, xp_l = ba._solve_from_lin(dpl.pl, lin, red, lam, cg_maxiter,
                                        cg_tol, dist=sums)
        trial = dist_ba.retract_global(state, xc_l, xp_l, dpl, mesh)
        err_t = dist_ba.dist_error(trial, dpl, mesh)
        ok = torch.isfinite(err_t) & (err_t < err)
        state = ba.BAState(*(torch.where(ok, a, b)
                             for a, b in zip(trial, state)))
        lam = torch.where(ok, torch.clamp(lam * 0.5, min=lam_lo),
                          torch.clamp(lam * 4.0, max=lam_hi))
        err = torch.where(ok, err_t, err)
        if i + 1 < n_iters:
            need_relin = bool(ok)           # the one host read
    return state, lam, err


def dist_pack_try_step(state_pad: ba.BAState, obs: ba.BAObservations,
                       dpl: DistPackLayout, lam, mesh: Mesh, cg_maxiter=25):
    """One LM try step on the distributed engine: solve, retract, and the
    error of the whole observation set."""
    xc, xp = dist_pack_solve_step(state_pad, dpl, lam, mesh,
                                  cg_maxiter=cg_maxiter)
    new_state = ba.retract_ba(state_pad, xc, xp)
    return new_state, ba.ba_error(new_state, obs)


def collective_overhead(state_pad, dpl, mesh, lam=1e-4, cg_maxiter=10,
                        iters=3):
    """dist_ba.time_split of dist_pack_solve_step: (t_full, t_local,
    fraction). With several ranks on one card the all-reduces go through
    host memory (gloo), so the fraction is that route's, not an
    interconnect's."""
    return dist_ba.time_split(lambda skip: dist_pack_solve_step(
        state_pad, dpl, lam, mesh, cg_maxiter=cg_maxiter,
        skip_collectives=skip), mesh, iters)
