"""Distributed bundle adjustment: cameras dealt over ranks, explicit
all-reduces.

JAX counterpart: gtsam_personal_tpu/parallel/dist_ba.py (DistBALayout,
pad_cameras, build_dist_layout, _solve_body, dist_solve_ba_step,
dist_ba_try_step, collective_overhead). There, one `shard_map` program
runs on every device of a mesh with `lax.psum` at the landmark aggregates;
here each rank is one process with its own program, and each `psum` is an
all-reduce on the rank's process group (parallel/mesh.py:Mesh).

Cameras, and with each camera all of its observations, are dealt to ranks;
the state (cameras padded to n Cl, landmarks) is held whole by every rank.
A rank keeps the flat camera-sorted `sfm/ba_layout.py:BALayout` of its own
observations, over local camera ids and local landmark slots, in place of
the JAX package's dense per-device rectangles. Each rank

  - linearizes only its observations;
  - sums its landmark-side partials (the landmark blocks and gradient once
    a linearization, E^T a in every Schur matvec) over the ranks for the
    landmarks seen from more than one rank, the "boundary": they are
    gathered into one [k, Ps] tensor in ascending landmark order, summed
    in one all-reduce and scattered back. Other landmarks' sums are whole
    on the one rank that sees them;
  - runs PCG on its cameras' block of the Schur system with the dot
    products summed over the ranks, so every rank takes the same steps.

The math is sfm/ba.py's Schur-PCG body (`_reduce_cache`, `_solve_from_lin`,
`_pcg`), shared with both single-device engines; `RankSums` is the one
optional argument that adds these sums. The landmark solves stay
ops/block_solve.py:landmark_block_solve, the hand-written CUDA kernel, on
every rank over its landmark slots. The cameras' and landmarks' steps are
put together by one all-reduce of disjoint rows: a camera's step comes
from its rank, a landmark's from its owner, the lowest rank that sees it
(rank 0 for a landmark nobody sees).

This module deals cameras contiguously (rank = camera // Cl) and gives
every rank all the boundary landmarks as a prefix of its slots, then the
landmarks only it sees, as the JAX module orders its landmarks by
ownership; its CG stops at `cg_tol`, reading the summed stop flag every 8
iterations (sfm/ba.py:solve_ba_step_cm's schedule). parallel/
dist_ba_pack.py deals cameras by observation count and runs the whole LM
loop over the same machinery.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.geometry import se3
from gtsam_personal_tpu_torch.parallel.mesh import Mesh
from gtsam_personal_tpu_torch.sfm import ba
from gtsam_personal_tpu_torch.sfm.ba_layout import BALayout, build_layout


class DistBALayout(NamedTuple):
    """One rank's share of a camera-dealt BA problem."""
    n: int                  # world size
    rank: int
    Cl: int                 # cameras a rank; the state has n * Cl cameras
    P: int                  # landmarks
    Ps: int                 # boundary landmarks, seen from > 1 rank
    rows: tuple             # observations on each rank
    pl: BALayout            # this rank's rows: pl.C = Cl, pl.P = slots
    cam_rows: torch.Tensor  # [Cl] state row of each local camera
    pt_ids: torch.Tensor    # [pl.P] landmark of each local slot
    b_slot: torch.Tensor    # [nb] local slots of the boundary landmarks
    b_idx: torch.Tensor     # [nb] their index in the ascending boundary
    own_slot: torch.Tensor  # [no] slots whose step this rank contributes
    mesh: Mesh              # the group the problem was dealt over


def pad_cameras(state: ba.BAState, n: int) -> ba.BAState:
    """Pad the camera count to a multiple of n with identity cameras (no
    observation references them; damping keeps them fixed)."""
    C = state.cam_poses.shape[0]
    pad = n * (-(-C // n)) - C
    if pad == 0:
        return state
    poses, cals = state.cam_poses, state.cam_cals
    eye = torch.eye(3, 4, dtype=poses.dtype, device=poses.device)
    cal = torch.tensor([1.0, 0.0, 0.0], dtype=cals.dtype, device=cals.device)
    return ba.BAState(torch.cat([poses, eye.expand(pad, 3, 4)]),
                      torch.cat([cals, cal.expand(pad, 3)]), state.points)


def deal_contiguous(C: int, n: int):
    """(rank of each camera, its index on the rank, Cl): camera c on rank
    c // Cl."""
    Cl = -(-C // n)
    dev = np.minimum(np.arange(C) // Cl, n - 1)
    return dev, np.arange(C) - dev * Cl, Cl


def build_rank_layout(obs: ba.BAObservations, C: int, P: int, mesh: Mesh,
                      dev_of_cam, loc_of_cam, Cl: int, prefix: bool,
                      partition_points: bool = True) -> DistBALayout:
    """This rank's layout for a deal of the C cameras (rank and index on
    the rank of each; the padded rows n Cl beyond C are identity cameras,
    each on the rank of its slot). Host-side, from the whole observation
    set, which every rank holds.

    prefix: the rank's landmark slots are every boundary landmark, then the
    landmarks it owns and no other rank sees; otherwise the landmarks its
    cameras see, ascending. partition_points=False makes every landmark a
    boundary landmark (the JAX module's all-shared mode)."""
    n, r = mesh.size, mesh.rank
    cam = obs.cam.cpu().numpy()
    pt = obs.point.cpu().numpy()
    uv = obs.uv.cpu().numpy()
    dev = dev_of_cam[cam]
    pairs = np.unique(dev * np.int64(P) + pt)       # (rank, landmark) seen
    d_u, p_u = pairs // P, pairs % P
    owner = np.full(P, n, dtype=np.int64)
    np.minimum.at(owner, p_u, d_u)
    owner[owner == n] = 0                            # seen by nobody
    if partition_points:
        boundary = np.flatnonzero(np.bincount(p_u, minlength=P) > 1)
    else:
        boundary = np.arange(P)
    Ps = boundary.size
    bidx = np.full(P, -1, dtype=np.int64)
    bidx[boundary] = np.arange(Ps)
    sel = np.flatnonzero(dev == r)
    if prefix:
        pt_ids = np.concatenate(
            [boundary, np.flatnonzero((owner == r) & (bidx < 0))])
    else:
        pt_ids = np.unique(pt[sel])
    slot_of = np.full(P, -1, dtype=np.int64)
    slot_of[pt_ids] = np.arange(pt_ids.size)
    new2orig = np.full(n * Cl, -1, dtype=np.int64)
    new2orig[dev_of_cam * Cl + loc_of_cam] = np.arange(C)
    virt = np.flatnonzero(new2orig < 0)
    new2orig[virt] = C + np.arange(virt.size)
    b_slot = np.flatnonzero(bidx[pt_ids] >= 0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                               device=mesh.device)

    pl = build_layout(loc_of_cam[cam[sel]], slot_of[pt[sel]], uv[sel], Cl,
                      pt_ids.size, device=mesh.device, dtype=obs.uv.dtype)
    return DistBALayout(
        n, r, Cl, P, Ps, tuple(np.bincount(dev, minlength=n).tolist()), pl,
        t(new2orig[r * Cl:(r + 1) * Cl]), t(pt_ids), t(b_slot),
        t(bidx[pt_ids[b_slot]]), t(np.flatnonzero(owner[pt_ids] == r)),
        mesh)


def build_dist_layout(obs: ba.BAObservations, C: int, P: int, mesh: Mesh,
                      partition_points: bool = True) -> DistBALayout:
    """This rank's layout: cameras dealt contiguously, landmark slots the
    boundary prefix then the rank's own landmarks (every landmark a
    boundary one with partition_points=False)."""
    dev, loc, Cl = deal_contiguous(C, mesh.size)
    return build_rank_layout(obs, C, P, mesh, dev, loc, Cl, prefix=True,
                             partition_points=partition_points)


class RankSums:
    """The sums over ranks that make sfm/ba.py's Schur-PCG body one rank's
    share of a distributed solve: `boundary` sums a [k, slots] tensor's
    boundary columns (gather to ascending boundary order, one [k, Ps]
    all-reduce, scatter back), `sums` a list of scalars (one all-reduce).
    With a mesh without collectives the gathers stay and the all-reduces go
    (the JAX psum_bnd's skip_collectives variant)."""

    def __init__(self, dl: DistBALayout, mesh: Mesh):
        self.mesh, self.Ps = mesh, dl.Ps
        self.b_slot, self.b_idx = dl.b_slot, dl.b_idx

    def boundary(self, t):
        if self.Ps == 0:
            return t
        tb = t.new_zeros((t.shape[0], self.Ps))
        tb.index_copy_(1, self.b_idx, t.index_select(1, self.b_slot))
        self.mesh.psum(tb)
        return t.index_copy(1, self.b_slot, tb.index_select(1, self.b_idx))

    def sums(self, xs):
        return self.mesh.sums(xs)


def rank_mesh(state: ba.BAState, dl: DistBALayout, mesh: Mesh,
              skip_collectives: bool = False) -> Mesh:
    """Check that `dl` is this rank's layout of `mesh` and that the state
    has the padded camera count; the mesh, without collectives if asked."""
    if (mesh.rank, mesh.size) != (dl.rank, dl.n):
        raise ValueError(f"layout of rank {dl.rank} of {dl.n} used on rank "
                         f"{mesh.rank} of {mesh.size}")
    if state.cam_poses.shape[0] != dl.n * dl.Cl:
        raise ValueError(f"state has {state.cam_poses.shape[0]} cameras, "
                         f"not {dl.n * dl.Cl}: pad it with pad_cameras")
    return mesh.without_collectives() if skip_collectives else mesh


def local_state(state: ba.BAState, dl: DistBALayout) -> ba.BAState:
    """The rank's cameras and landmark slots of the whole state."""
    return ba.BAState(state.cam_poses[dl.cam_rows],
                      state.cam_cals[dl.cam_rows], state.points[dl.pt_ids])


def rows_sum(mesh: Mesh, parts):
    """Each part (n_rows, rows, values [len(rows), w]) written into zeros
    [n_rows, w] at `rows`, all parts summed over the ranks in one
    all-reduce; returns the [n_rows, w] tensors. Ranks write disjoint rows,
    so the sum puts the rows together."""
    bufs = [v.new_zeros((n, v.shape[1])).index_copy_(0, rows, v)
            for n, rows, v in parts]
    flat = mesh.psum(torch.cat([b.reshape(-1) for b in bufs]))
    return [f.view(b.shape) for f, b in zip(
        flat.split([b.numel() for b in bufs]), bufs)]


def solve_local(state: ba.BAState, dl: DistBALayout, lam, mesh: Mesh,
                cg_maxiter, cg_tol, check_every):
    """The rank's Schur-PCG solve from a fresh linearization: (xc [Cl, 9],
    xp [slots, 3])."""
    sums = RankSums(dl, mesh)
    lin = ba.linearize_ba_cm(local_state(state, dl), None, dl.pl)
    return ba._solve_from_lin(dl.pl, lin, ba._reduce_cache(dl.pl, lin, sums),
                              lam, cg_maxiter, cg_tol,
                              check_every=check_every, dist=sums)


def assemble_step(xc_l, xp_l, dl: DistBALayout, mesh: Mesh):
    """The whole step (xc [n Cl, 9], xp [P, 3]) from the ranks' shares, in
    one all-reduce."""
    own = dl.own_slot
    return tuple(rows_sum(mesh, [(dl.n * dl.Cl, dl.cam_rows, xc_l),
                                 (dl.P, dl.pt_ids[own], xp_l[own])]))


def retract_global(state: ba.BAState, xc_l, xp_l, dl: DistBALayout,
                   mesh: Mesh) -> ba.BAState:
    """Each rank retracts its own cameras; the whole state is rebuilt from
    the ranks' disjoint camera rows and owned landmark steps in one
    all-reduce."""
    poses = se3.retract(state.cam_poses[dl.cam_rows], xc_l[:, :6])
    cals = state.cam_cals[dl.cam_rows] + xc_l[:, 6:9]
    own = dl.own_slot
    cams, dxp = rows_sum(mesh, [
        (dl.n * dl.Cl, dl.cam_rows,
         torch.cat([poses.reshape(-1, 12), cals], dim=1)),
        (dl.P, dl.pt_ids[own], xp_l[own])])
    return ba.BAState(cams[:, :12].reshape(-1, 3, 4),
                      cams[:, 12:].contiguous(), state.points + dxp)


def dist_error(state: ba.BAState, dl: DistBALayout, mesh: Mesh):
    """The total error: this rank's rows, summed over the ranks (0-d)."""
    e = ba.ba_error_cm(local_state(state, dl), None, dl.pl)
    return mesh.psum(e.reshape(1))[0]


def dist_solve_ba_step(state_pad: ba.BAState, dl: DistBALayout, lam,
                       mesh: Mesh, cg_maxiter=25, cg_tol=1e-6,
                       skip_collectives: bool = False):
    """Camera-dealt implicit-Schur solve, PCG stopping at cg_tol (the
    summed flag read every 8 iterations). Returns (xc [n Cl, 9], xp [P,
    3]), the same on every rank."""
    mesh = rank_mesh(state_pad, dl, mesh, skip_collectives)
    xc_l, xp_l = solve_local(state_pad, dl, lam, mesh, cg_maxiter, cg_tol,
                             check_every=8)
    return assemble_step(xc_l, xp_l, dl, mesh)


def dist_ba_try_step(state_pad: ba.BAState, obs: ba.BAObservations,
                     dl: DistBALayout, lam, mesh: Mesh, cg_maxiter=25):
    """One LM try step: distributed solve + retract + error."""
    xc, xp = dist_solve_ba_step(state_pad, dl, lam, mesh,
                                cg_maxiter=cg_maxiter)
    new_state = ba.retract_ba(state_pad, xc, xp)
    return new_state, ba.ba_error(new_state, obs)


def sync(mesh: Mesh):
    """Wait for the card of the mesh's device (nothing on the CPU)."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def time_split(solve, mesh: Mesh, iters: int):
    """Compute/collective split proxy: seconds a call of solve(skip) with
    the all-reduces and without them (the same work, no communication),
    each the mean over the ranks of a timed run of `iters` calls after one
    untimed call, the ranks started together; returns (t_full, t_local,
    1 - t_local / t_full clipped at 0)."""
    def run(skip):
        solve(skip)
        sync(mesh)
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            solve(skip)
        sync(mesh)
        return (time.perf_counter() - t0) / iters

    times = torch.tensor([run(False), run(True)], dtype=torch.float64,
                         device=mesh.device)
    t_full, t_local = (mesh.psum(times) / mesh.size).tolist()
    frac = max(0.0, 1.0 - t_local / t_full) if t_full > 0 else 0.0
    return t_full, t_local, frac


def collective_overhead(state_pad, dl, mesh, lam=1e-4, cg_maxiter=10,
                        iters=3):
    """time_split of dist_solve_ba_step. With several ranks on one card the
    all-reduces go through host memory (gloo), so the fraction is that
    route's, not an interconnect's."""
    return time_split(lambda skip: dist_solve_ba_step(
        state_pad, dl, lam, mesh, cg_maxiter=cg_maxiter,
        skip_collectives=skip), mesh, iters)
