"""The partitioned Schur solve with its fronts dealt over ranks.

JAX counterpart: gtsam_personal_tpu/parallel/dist_schur.py (DistSchurPlan,
_device_body, solve_partitioned_sharded, collective_overhead). The
nested-dissection parts of a `linear/schur.py:SchurPlan` are dealt to ranks
in contiguous blocks of pp = ceil(p / n). Each rank assembles, factors and
eliminates only its own fronts, and adds their Schur complements into its
copy of the [S+1]^2 separator system; the separator-only factors' entries
are dealt in even chunks. Then

  - the separator system and its right-hand side are summed over the ranks
    in one all-reduce, and every rank solves the (small, dense) separator
    system;
  - each rank back-substitutes its own fronts, and the tangent is put
    together by one all-reduce: a variable's step comes from the rank of
    its part, a separator variable's from rank 0.

The stages are linear/schur.py's (assemble, factor_interiors,
eliminate_interiors, extend_add, solve_separator, back_substitute), run on
a rank's slice of the plan: the same tables restricted to the rank's parts,
with part ids made local. Every rank holds pp parts; a rank short of them
(the last, when n does not divide p) pads with empty parts, whose identity
interiors and zero separator blocks add nothing.

Dead targets: a padded separator column (l2g) points at S, and a dead
extend-add entry at row or column S: the pad slot inside the separator
buffer, as in the single-device plan. Every target of a rank's slice is
checked against its buffer when the slice is built (the JAX plan points
dead targets past the end and relies on a dropping scatter, which
`index_add_` does not have).
"""

from typing import NamedTuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.linear import schur as _schur
from gtsam_personal_tpu_torch.linear.schur import SchurPlan
from gtsam_personal_tpu_torch.parallel import dist_ba
from gtsam_personal_tpu_torch.parallel.mesh import Mesh


class RankPlan(NamedTuple):
    """The fields of a SchurPlan that linear/schur.py's stages read, for
    one rank's pp parts."""
    p: int
    m: int
    D_max: int
    sd_max: int
    S_dim: int
    pad_mask: torch.Tensor      # [pp, D_max]
    l2g: torch.Tensor           # [pp, sd_max], dead -> S
    asm: dict                   # flat targets in the rank's buffers
    ea_buckets: list
    sol_maps: dict              # part ids local, clipped into [0, pp)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def check_targets(rp: RankPlan):
    """Raise ValueError unless every scatter and gather target of the
    slice lies inside its buffer."""
    Sfw = rp.S_dim + 1
    size = {"fronts": rp.p * rp.m * rp.m, "rhs": rp.p * rp.m,
            "ssys": Sfw * Sfw, "srhs": Sfw}
    named = [(k, rp.asm[k], size[k]) for k in size]
    named.append(("l2g", rp.l2g, Sfw))
    for eb in rp.ea_buckets:
        named += [("extend-add", eb["tgt"], Sfw * Sfw),
                  ("extend-add rhs", eb["tgt_rhs"], Sfw),
                  ("extend-add parts", eb["ids"], rp.p)]
    for g, smap in rp.sol_maps.items():
        named += [(f"{g} part", smap["part"], rp.p),
                  (f"{g} row", _np(smap["row"]) + smap["dim"],
                   rp.D_max + 1),
                  (f"{g} separator position", _np(smap["sep_pos"]),
                   Sfw)]
    for name, t, n in named:
        t = _np(t)
        if t.size and (t.min() < 0 or t.max() >= n):
            raise ValueError(f"{name} target {t.min()}..{t.max()} outside "
                             f"its buffer of {n}")


class DistSchurPlan:
    """One rank's split of a SchurPlan over a mesh.

    gather: for each of schur_values' four value vectors, the indices of
    the entries this rank assembles; rank_plan: the rank's slice of the
    plan; owned: per variable group, the variables whose step this rank
    contributes to the tangent."""

    def __init__(self, plan: SchurPlan, mesh: Mesh):
        self.plan, self.mesh = plan, mesh
        n, d = mesh.size, mesh.rank
        p, m, S = plan.p, plan.m, plan.S_dim
        Sfw = S + 1
        pp = max(-(-p // n), 1)
        lo, hi = d * pp, max(min((d + 1) * pp, p), d * pp)
        self.pp = pp
        dev = mesh.device

        def owned_entries(tgt, block):
            sel = np.flatnonzero((tgt // block) // pp == d)
            return sel, tgt[sel] - d * pp * block

        def chunk(tgt):
            L = -(-tgt.size // n)
            sel = np.arange(min(d * L, tgt.size), min((d + 1) * L, tgt.size))
            return sel, tgt[sel]

        asm = {k: _np(v) for k, v in plan.asm.items()}
        picks = {"fronts": owned_entries(asm["fronts"], m * m),
                 "rhs": owned_entries(asm["rhs"], m),
                 "ssys": chunk(asm["ssys"]), "srhs": chunk(asm["srhs"])}
        D = np.zeros(pp, dtype=np.int64)
        D[:hi - lo] = plan.D[lo:hi]
        l2g = np.full((pp, plan.sd_max), S, dtype=np.int64)
        l2g[:hi - lo] = _np(plan.l2g)[lo:hi]
        buckets = []
        for eb in plan.ea_buckets:
            ids = _np(eb["ids"])
            ids = ids[(ids >= lo) & (ids < hi)] - lo
            if ids.size == 0:
                continue
            l2g_b = l2g[ids][:, :eb["sdb"]]
            buckets.append({"ids": ids, "sdb": eb["sdb"],
                            "tgt": (l2g_b[:, :, None] * Sfw
                                    + l2g_b[:, None, :]).ravel(),
                            "tgt_rhs": l2g_b.ravel()})
        sol_maps, self.owned = {}, {}
        for g, smap in plan.sol_maps.items():
            part, in_sep = _np(smap["part"]), _np(smap["in_sep"])
            sol_maps[g] = {"part": np.clip(part - lo, 0, pp - 1),
                           "row": _np(smap["row"]), "in_sep": in_sep,
                           "sep_pos": _np(smap["sep_pos"]),
                           "dim": smap["dim"]}
            self.owned[g] = ((part // pp == d) & ~in_sep) | (in_sep & (d == 0))
        rp = RankPlan(pp, m, plan.D_max, plan.sd_max, S,
                      np.arange(plan.D_max)[None, :] >= D[:, None], l2g,
                      {k: v[1] for k, v in picks.items()}, buckets, sol_maps)
        check_targets(rp)

        def t(a):
            return torch.as_tensor(a, device=dev)
        self.gather = {k: t(v[0]) for k, v in picks.items()}
        self.owned = {g: t(v) for g, v in self.owned.items()}
        self.rank_plan = rp._replace(
            pad_mask=t(rp.pad_mask), l2g=t(l2g),
            asm={k: t(v) for k, v in rp.asm.items()},
            ea_buckets=[{"ids": t(eb["ids"]), "sdb": eb["sdb"],
                         "tgt": t(eb["tgt"]), "tgt_rhs": t(eb["tgt_rhs"])}
                        for eb in buckets],
            sol_maps={g: {k: (v if k == "dim" else t(v))
                          for k, v in smap.items()}
                      for g, smap in sol_maps.items()})


def solve_partitioned_sharded(lin, dplan: DistSchurPlan, mesh: Mesh,
                              lam=0.0, skip_collectives: bool = False):
    """Exact damped normal-equations solve with the fronts dealt over the
    ranks; the tangent dict, the same on every rank. Matches
    schur.solve_partitioned up to summation order.
    `skip_collectives=True` makes every all-reduce the identity (a wrong
    result), only to measure their share (collective_overhead)."""
    if (mesh.rank, mesh.size) != (dplan.mesh.rank, dplan.mesh.size):
        raise ValueError("the plan was split for another rank")
    if skip_collectives:
        mesh = mesh.without_collectives()
    rp = dplan.rank_plan
    values = _schur.schur_values(lin, dplan.plan)
    lam = torch.as_tensor(lam, dtype=values[0].dtype, device=values[0].device)
    fronts, rhs, ssys, srhs = _schur.assemble(
        [v[dplan.gather[k]] for v, k in zip(values, ("fronts", "rhs", "ssys",
                                                     "srhs"))], rp)
    chol = _schur.factor_interiors(fronts, rp, lam)
    y, W, schur_c, rhs_s = _schur.eliminate_interiors(chol, fronts, rhs, rp)
    if W is not None:
        _schur.extend_add(ssys, srhs, schur_c, rhs_s, rp)
    ssys, srhs = mesh.psum(torch.cat([ssys, srhs])).split(
        [ssys.numel(), srhs.numel()])
    dsep_pad = _schur.solve_separator(ssys, srhs, rp, lam)
    delta = _schur.back_substitute(y, W, dsep_pad, rp)
    return mesh.psum_tree({g: torch.where(dplan.owned[g][:, None], x, 0.0)
                           for g, x in delta.items()})


def collective_overhead(lin, dplan: DistSchurPlan, mesh: Mesh, lam=1e-4,
                        iters: int = 5):
    """parallel/dist_ba.py:time_split of the sharded solve: (t_full,
    t_local, fraction), the ranks' means."""
    return dist_ba.time_split(lambda skip: solve_partitioned_sharded(
        lin, dplan, mesh, lam, skip_collectives=skip), mesh, iters)
