"""Multi-level (recursive) partitioned Schur elimination.

JAX counterpart: gtsam_personal_tpu/linear/mlschur.py (all of it; reference:
the recursive junction tree of inference/ClusterTree-inst.h:286 and
JunctionTree.h:49). The two-level solver (linear/schur.py) eliminates every
interior part in one batched pass but solves the WHOLE separator as one
dense system. This module recurses: the separator is itself bisected into
interior parts and a smaller separator, level after level, until the top
("root") system is small. Each level is one batched front elimination; the
depth of the tree is the only sequential axis.

Two structural facts make the index plumbing tractable:
  * with a VERTEX separator no factor (or clique) can span two interiors;
  * a part's local-separator variable set is one clique, so at the next
    level it is assigned to exactly ONE part (or the root): every entry of
    a part's Schur-complement slab routes to the same destination front.

All routing is computed once per graph structure on the host and kept as
int64 tensors on the device of the graph's index tensors. The device
program is: per level assemble, batched Cholesky and slab scatter
(`index_add_`); a dense root solve; a downward gather and back-substitution.

Every flat buffer ends in one pad slot that nothing reads. A scatter
target that carries no live value points at its buffer's pad slot, and the
plan checks that every target lies inside its buffer when it is built:
`index_add_` has no drop mode, so an out-of-range target would raise on the
CPU and write out of bounds on a card. (The JAX plan points dead right-hand
side targets past the end of the buffer and lets `mode="drop"` discard
them.) The JAX package's feature-major input (`fm.FMGraph`) and its packed
int32 upload are TPU layouts and are not taken here.
"""

from typing import Dict, List

import numpy as np
import scipy.sparse as sp
import torch

from gtsam_personal_tpu_torch import native
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.inference.partition import (batch_vids,
                                                          build_adjacency,
                                                          partition_nodes)
from gtsam_personal_tpu_torch.linear.schur import _exclusive_cumsum
from gtsam_personal_tpu_torch.linear.solvers import cholesky_nan

ROOT = "root"
_ROOT_LEVEL = 10 ** 6          # level_of sentinel of a root variable


def _expand(starts, dims):
    """Concatenated ranges starts[i] + arange(dims[i]) (int64)."""
    starts = np.asarray(starts, dtype=np.int64)
    dims = np.asarray(dims, dtype=np.int64)
    rep = np.repeat(np.arange(starts.size), dims)
    return starts[rep] + (np.arange(rep.size) - _exclusive_cumsum(dims)[rep])


class MLPlan:
    """Static L-level elimination plan for one graph structure.

    Its tables equal the JAX plan's entry for entry (`batch_asm`, `asm_tgt`,
    `ea`, `l2sol`, `delta_gather`), but for the dead right-hand-side
    targets, which point at the pad slot here. Each level's local-separator
    layout is kept as sorted keys `part * num_vars + var` with their column
    offsets (`lsep_keys`, `lsep_lo`) instead of a dict a part."""

    def __init__(self, graph, counts: Dict[str, int], max_part_size=128,
                 root_max_dim=768, max_levels=4):
        vi, A = build_adjacency(graph, counts)
        nv = vi.num_vars
        dims = vi.dims
        device = graph.batches[0].idx.device
        vids_b = [batch_vids(b, vi) for b in graph.batches]   # [K, S] each

        # ---- the level hierarchy (host) ----
        # hyperedges at level 0 are the factors; at level l+1 the parts'
        # local-separator cliques ("slabs") and the factors left unplaced
        self.levels: List[dict] = []
        cur_nodes = np.arange(nv)
        level_of = np.full(nv, -1, dtype=np.int64)      # interior level
        part_of_lvl = np.full(nv, -1, dtype=np.int64)
        int_off = np.full(nv, -1, dtype=np.int64)       # column in its front
        fac_level = [np.full(v.shape[0], -1, dtype=np.int64) for v in vids_b]
        fac_part = [np.full(v.shape[0], -1, dtype=np.int64) for v in vids_b]
        pending_slabs: List[dict] = []                  # vars, src, dst
        lvl = 0
        while True:
            # the bisection adjacency includes the slab cliques: without
            # them a slab could span two interiors
            rr = [np.repeat(s["vars"], s["vars"].size) for s in pending_slabs
                  if s["dst"] is None and s["vars"].size >= 2]
            cc = [np.tile(s["vars"], s["vars"].size) for s in pending_slabs
                  if s["dst"] is None and s["vars"].size >= 2]
            if rr:
                r, c = np.concatenate(rr), np.concatenate(cc)
                extra = sp.coo_matrix((np.ones(len(r), dtype=np.int8),
                                       (r, c)), shape=A.shape).tocsr()
                Acur = ((A + extra) > 0).astype(np.int8).tocsr()
            else:
                Acur = A
            parts, sep = partition_nodes(Acur, cur_nodes, max_part_size)
            sep_dim = int(dims[sep].sum()) if sep.size else 0
            if (sep_dim <= root_max_dim or lvl + 1 >= max_levels
                    or sep.size == 0):
                break                   # everything left is the root
            part_of = np.full(nv, -2, dtype=np.int64)
            for k, p in enumerate(parts):
                part_of[p] = k
            part_of[sep] = -1

            # place the factors not yet placed; collect, as keys
            # part * nv + var, the separator variables each part touches
            keys = [np.zeros(0, dtype=np.int64)]
            for bi, vids in enumerate(vids_b):
                rows = np.where(fac_level[bi] < 0)[0]
                if rows.size == 0:
                    continue
                fp = native.classify_factors(vids[rows], part_of)
                placed = fp >= 0
                fac_level[bi][rows[placed]] = lvl
                fac_part[bi][rows[placed]] = fp[placed]
                v = vids[rows[placed]]
                on_sep = part_of[v] == -1
                keys.append((fp[placed][:, None] * nv + v)[on_sep])
            # place the pending slabs of the previous level
            for slab in pending_slabs:
                if slab["dst"] is not None:
                    continue
                sv = slab["vars"]
                pp = part_of[sv]
                ik = pp[pp >= 0]
                if ik.size:
                    k = int(ik[0])
                    if not (ik == k).all():
                        raise RuntimeError("a slab spans two interiors")
                    slab["dst"] = (lvl, k)
                    keys.append(k * nv + sv[pp == -1])
                # else: it stays pending for the next level

            # interior layouts
            D = np.zeros(len(parts), dtype=np.int64)
            for k, p in enumerate(parts):
                level_of[p] = lvl
                part_of_lvl[p] = k
                int_off[p] = _exclusive_cumsum(dims[p])
                D[k] = dims[p].sum()
            # local-separator layouts: keys sorted by part, then var
            keys = np.unique(np.concatenate(keys))
            key_part, key_dim = keys // nv, dims[keys % nv]
            run = _exclusive_cumsum(key_dim)
            lsep_lo = run - run[np.searchsorted(key_part, key_part)]
            sd = np.bincount(key_part, weights=key_dim,
                             minlength=len(parts)).astype(np.int64)
            self.levels.append({
                "parts": parts, "D": D, "sd": sd,
                "Dmax": int(D.max()) if len(parts) else 0,
                "sdmax": int(sd.max()) if len(parts) else 1,
                "lsep_keys": keys, "lsep_lo": lsep_lo,
            })
            # this level's slabs become pending hyperedges
            for k in range(len(parts)):
                pending_slabs.append({"vars": keys[key_part == k] % nv,
                                      "src": (lvl, k), "dst": None})
            cur_nodes = sep
            lvl += 1

        # ---- root layout ----
        root_vars = np.sort(np.asarray(cur_nodes, dtype=np.int64))
        root_off = np.full(nv, -1, dtype=np.int64)
        root_off[root_vars] = _exclusive_cumsum(dims[root_vars])
        level_of[root_vars] = _ROOT_LEVEL
        self.R_dim = int(dims[root_vars].sum())
        self.L = len(self.levels)

        # ---- flat solution-vector layout: level segments, then the root ----
        sol_base, off = [], 0
        for L in self.levels:
            sol_base.append(off)
            off += len(L["parts"]) * L["Dmax"]
        self.sol_root_base = off
        off += self.R_dim
        self.sol_pad = off                       # one zero pad slot
        self.sol_total = off + 1
        self.sol_base = sol_base
        # global solution index of each var's first tangent coordinate
        sol_start = np.full(nv, -1, dtype=np.int64)
        for lv, L in enumerate(self.levels):
            vs = np.where(level_of == lv)[0]
            sol_start[vs] = (sol_base[lv] + part_of_lvl[vs] * L["Dmax"]
                             + int_off[vs])
        sol_start[root_vars] = self.sol_root_base + root_off[root_vars]

        def lsep_col(lv, k, v):
            """Column (after Dmax) of var v in part k's local separator."""
            L = self.levels[lv]
            return L["lsep_lo"][np.searchsorted(L["lsep_keys"], k * nv + v)]

        def front_col(lv, k, v):
            """Column of var v in the level-lv front of part k (arrays)."""
            own = (level_of[v] == lv) & (part_of_lvl[v] == k)
            col = np.zeros(np.shape(v), dtype=np.int64)
            col[own] = int_off[v[own]]
            col[~own] = self.levels[lv]["Dmax"] + lsep_col(
                lv, np.broadcast_to(k, np.shape(v))[~own], v[~own])
            return col

        # ---- factor assembly plans, per level + root ----
        # value order: batches -> levels -> slot pairs -> k-major ravel over
        # the rows selected for that level
        Rfw = self.R_dim + 1
        self.Rfw = Rfw
        self.batch_asm = []      # per batch: {level: {sel, part, col [n, S]}}
        for bi, vids in enumerate(vids_b):
            per_level = {}
            for lv in list(range(self.L)) + [ROOT]:
                rows = np.where(fac_level[bi] == (-1 if lv == ROOT else lv)
                                )[0]
                if rows.size == 0:
                    continue
                v = vids[rows]
                if lv == ROOT:
                    col, part = root_off[v], None
                else:
                    part = fac_part[bi][rows]
                    col = front_col(lv, part[:, None], v)
                per_level[lv] = {"sel": rows, "part": part, "col": col}
            self.batch_asm.append(per_level)

        # ---- flat scatter targets per level / root ----
        asm = {lv: {"blk": [], "rhs": []}
               for lv in list(range(self.L)) + [ROOT]}
        for bi, b in enumerate(graph.batches):
            dims_b = [manifolds.get(g).dim for g in b.groups]
            for lv, ap in self.batch_asm[bi].items():
                col = ap["col"]
                if lv == ROOT:
                    m, base = Rfw, np.zeros(col.shape[0], dtype=np.int64)
                else:
                    m = self.levels[lv]["Dmax"] + self.levels[lv]["sdmax"]
                    base = ap["part"]
                for s in range(len(b.groups)):
                    rows_s = col[:, s, None] + np.arange(dims_b[s])
                    asm[lv]["rhs"].append((base[:, None] * m
                                           + rows_s).ravel())
                    for t in range(len(b.groups)):
                        cols_t = col[:, t, None] + np.arange(dims_b[t])
                        asm[lv]["blk"].append((base[:, None, None] * (m * m)
                                               + rows_s[:, :, None] * m
                                               + cols_t[:, None, :]).ravel())
        self.asm_tgt = {lv: {k: (np.concatenate(x) if x
                                 else np.zeros(0, np.int64))
                             for k, x in d.items()} for lv, d in asm.items()}

        # ---- extend-add routing: level-l slabs -> later fronts / root ----
        # bucketed by live slab size as in schur.py; dead entries of a
        # bucket point at the destination buffer's pad slot
        self.ea = []
        for lv, L in enumerate(self.levels):
            p, sd, sdmax = len(L["parts"]), L["sd"], L["sdmax"]
            colmap = np.full((p, max(sdmax, 1)), -1, dtype=np.int64)
            dst_level = np.full(p, -9, dtype=np.int64)  # -9 empty, -1 root
            dst_part = np.zeros(p, dtype=np.int64)
            for slab in pending_slabs:
                if slab["src"][0] != lv or slab["vars"].size == 0:
                    continue
                k, sv = slab["src"][1], slab["vars"]
                src = _expand(lsep_col(lv, k, sv), dims[sv])
                if slab["dst"] is None:
                    dst_level[k] = -1
                    colmap[k, src] = _expand(root_off[sv], dims[sv])
                else:
                    dl, dk = slab["dst"]
                    dst_level[k], dst_part[k] = dl, dk
                    colmap[k, src] = _expand(front_col(dl, dk, sv), dims[sv])
            order = np.argsort(-sd)
            nb = min(8, p) if p else 0
            bounds = np.linspace(0, p, nb + 1).astype(int) if p else []
            buckets = []
            for biq in range(nb):
                ids = order[bounds[biq]:bounds[biq + 1]]
                ids = ids[sd[ids] > 0]
                if ids.size == 0:
                    continue
                sdb = int(sd[ids].max())
                tgt_by_dst = {}
                for dl in set(dst_level[ids].tolist()):
                    if dl == -9:
                        continue
                    if dl == -1:
                        m2 = Rfw
                        pad_blk, pad_rhs = Rfw * Rfw, Rfw
                    else:
                        m2 = (self.levels[dl]["Dmax"]
                              + self.levels[dl]["sdmax"])
                        p2 = len(self.levels[dl]["parts"])
                        pad_blk, pad_rhs = p2 * m2 * m2, p2 * m2
                    tgt = np.full((ids.size, sdb, sdb), pad_blk, np.int64)
                    tgt_r = np.full((ids.size, sdb), pad_rhs, np.int64)
                    for t, k in enumerate(ids):
                        if dst_level[k] != dl:
                            continue
                        cm = colmap[k, :sdb].copy()
                        live = cm >= 0
                        cm[~live] = 0
                        if dl == -1:
                            addr = cm[:, None] * Rfw + cm[None, :]
                            addr_r = cm
                        else:
                            addr = (dst_part[k] * (m2 * m2)
                                    + cm[:, None] * m2 + cm[None, :])
                            addr_r = dst_part[k] * m2 + cm
                        mask2 = live[:, None] & live[None, :]
                        tgt[t][mask2] = addr[mask2]
                        tgt_r[t][live] = addr_r[live]
                    tgt_by_dst[dl] = {"tgt": tgt.ravel(),
                                      "tgt_rhs": tgt_r.ravel()}
                buckets.append({"ids": ids, "sdb": sdb, "dst": tgt_by_dst})
            self.ea.append(buckets)

        # ---- back-substitution gathers: local sep col -> solution index ----
        self.l2sol = []
        for lv, L in enumerate(self.levels):
            m = np.full((len(L["parts"]), max(L["sdmax"], 1)), self.sol_pad,
                        dtype=np.int64)
            keys = L["lsep_keys"]
            k, v = keys // nv, keys % nv
            rep = np.repeat(np.arange(keys.size), dims[v])
            m[k[rep], _expand(L["lsep_lo"], dims[v])] = _expand(
                sol_start[v], dims[v])
            self.l2sol.append(m)

        # ---- final per-group delta gathers ----
        self.delta_gather = {}
        for g in sorted(counts):
            d = manifolds.get(g).dim
            v = vi.vid(g, np.arange(counts[g]))
            self.delta_gather[g] = sol_start[v][:, None] + np.arange(d)

        self.counts = dict(counts)
        self._check_targets()
        self._to_device(device)

    def buffer_sizes(self):
        """{level or ROOT: (block buffer size, rhs buffer size)}: each flat
        buffer with its pad slot, the last entry."""
        out = {ROOT: (self.Rfw * self.Rfw + 1, self.Rfw + 1)}
        for lv, L in enumerate(self.levels):
            p, m = len(L["parts"]), L["Dmax"] + L["sdmax"]
            out[lv] = (p * m * m + 1, p * m + 1)
        return out

    def scatter_targets(self):
        """(name, targets, size of the buffer they index) of every scatter
        and gather the solve makes."""
        sizes = self.buffer_sizes()
        for lv, t in self.asm_tgt.items():
            yield f"asm_tgt[{lv}].blk", t["blk"], sizes[lv][0]
            yield f"asm_tgt[{lv}].rhs", t["rhs"], sizes[lv][1]
        for lv, buckets in enumerate(self.ea):
            for i, bucket in enumerate(buckets):
                for dl, tt in bucket["dst"].items():
                    blk, rhs = sizes[ROOT if dl == -1 else dl]
                    yield f"ea[{lv}][{i}][{dl}].tgt", tt["tgt"], blk
                    yield f"ea[{lv}][{i}][{dl}].tgt_rhs", tt["tgt_rhs"], rhs
        for lv, m in enumerate(self.l2sol):
            yield f"l2sol[{lv}]", m, self.sol_total
        for g, gi in self.delta_gather.items():
            yield f"delta_gather[{g}]", gi, self.sol_total

    def _check_targets(self):
        for name, tgt, size in self.scatter_targets():
            t = np.asarray(tgt)
            if t.size and (t.min() < 0 or t.max() >= size):
                raise RuntimeError(f"MLPlan: {name} has a target outside "
                                   f"its buffer of {size}")

    def _to_device(self, device):
        def move(container, key):
            container[key] = torch.as_tensor(container[key], device=device)
        for t in self.asm_tgt.values():
            move(t, "blk")
            move(t, "rhs")
        for per_level in self.batch_asm:
            for ap in per_level.values():
                move(ap, "sel")
        for buckets in self.ea:
            for bucket in buckets:
                move(bucket, "ids")
                for tt in bucket["dst"].values():
                    move(tt, "tgt")
                    move(tt, "tgt_rhs")
        for lv, L in enumerate(self.levels):
            self.l2sol[lv] = torch.as_tensor(self.l2sol[lv], device=device)
            L["pad_mask"] = torch.as_tensor(
                np.arange(L["Dmax"])[None, :] >= L["D"][:, None],
                device=device)
        for g in self.delta_gather:
            self.delta_gather[g] = torch.as_tensor(self.delta_gather[g],
                                                   device=device)

    def stats(self):
        return {
            "levels": self.L,
            "parts": [len(L["parts"]) for L in self.levels],
            "Dmax": [L["Dmax"] for L in self.levels],
            "sdmax": [L["sdmax"] for L in self.levels],
            "root_dim": self.R_dim,
        }


def make_ml_plan(graph, counts, max_part_size=128, root_max_dim=768,
                 max_levels=4) -> MLPlan:
    return MLPlan(graph, counts, max_part_size, root_max_dim, max_levels)


def _batch_values(b, sel):
    """(blocks, rhs) scatter values for the rows `sel` of one batch, in the
    plan's fixed order (slot pairs, k-major ravel)."""
    nslots = len(b.groups)
    Js = [b.Js[s][sel] for s in range(nslots)]
    r = b.r[sel]
    blk, rhs = [], []
    for s in range(nslots):
        rhs.append(-torch.einsum("kij,ki->kj", Js[s], r).reshape(-1))
        for t in range(nslots):
            blk.append(torch.einsum("kij,kil->kjl", Js[s],
                                    Js[t]).reshape(-1))
    return blk, rhs


def assemble(lin, plan: MLPlan):
    """Flat block and rhs buffers of every level's fronts and of the root,
    each with its pad slot: ([fronts], [rhs], root_sys, root_rhs)."""
    r0 = lin.batches[0].r
    vals = {lv: ([], []) for lv in plan.asm_tgt}
    for b, per_level in zip(lin.batches, plan.batch_asm):
        for lv, ap in per_level.items():
            blk, rhs = _batch_values(b, ap["sel"])
            vals[lv][0].extend(blk)
            vals[lv][1].extend(rhs)

    def scatter(lv, which, size, i):
        buf = r0.new_zeros(size)
        if vals[lv][i]:
            buf.index_add_(0, plan.asm_tgt[lv][which], torch.cat(vals[lv][i]))
        return buf
    sizes = plan.buffer_sizes()
    fronts = [scatter(lv, "blk", sizes[lv][0], 0) for lv in range(plan.L)]
    rhs = [scatter(lv, "rhs", sizes[lv][1], 1) for lv in range(plan.L)]
    return (fronts, rhs, scatter(ROOT, "blk", sizes[ROOT][0], 0),
            scatter(ROOT, "rhs", sizes[ROOT][1], 1))


def eliminate_level(lv, fronts, rhs, root_sys, root_rhs, plan: MLPlan, lam):
    """Level lv's batched elimination: Cholesky of the damped interiors (pad
    rows get a unit diagonal), y = A^{-1} g, W = A^{-1} B, and the Schur
    slabs C - B^T W, g_s - B^T y added, in place, into the fronts of later
    levels and the root. Returns (y, W)."""
    L = plan.levels[lv]
    p, Dm, sdm = len(L["parts"]), L["Dmax"], L["sdmax"]
    m = Dm + sdm
    F = fronts[lv][:-1].view(p, m, m)
    G = rhs[lv][:-1].view(p, m)
    A = F[:, :Dm, :Dm].clone()
    A.diagonal(dim1=-2, dim2=-1).add_(
        torch.where(L["pad_mask"], torch.ones_like(lam), lam))
    chol = cholesky_nan(A)
    y = torch.cholesky_solve(G[:, :Dm, None], chol)[..., 0]
    if sdm == 0:
        return y, None
    B = F[:, :Dm, Dm:]
    Bt = B.transpose(-1, -2)
    W = torch.cholesky_solve(B, chol)
    schur = F[:, Dm:, Dm:] - Bt @ W
    rhs_s = G[:, Dm:] - (Bt @ y[..., None])[..., 0]
    for bucket in plan.ea[lv]:
        sdb = bucket["sdb"]
        Sb = schur[bucket["ids"]][:, :sdb, :sdb].reshape(-1)
        Rb = rhs_s[bucket["ids"]][:, :sdb].reshape(-1)
        for dl, tt in bucket["dst"].items():
            blk_buf, rhs_buf = ((root_sys, root_rhs) if dl == -1
                                else (fronts[dl], rhs[dl]))
            blk_buf.index_add_(0, tt["tgt"], Sb)
            rhs_buf.index_add_(0, tt["tgt_rhs"], Rb)
    return y, W


def solve_root(root_sys, root_rhs, plan: MLPlan, lam):
    """The flat solution vector [sol_total] with the damped root system's
    dense Cholesky solve in its root segment (zeros elsewhere)."""
    sol = root_rhs.new_zeros(plan.sol_total)
    R = plan.R_dim
    if R > 0:
        Rsys = root_sys[:-1].view(plan.Rfw, plan.Rfw)[:R, :R].clone()
        Rsys.diagonal().add_(lam)
        sol[plan.sol_root_base:plan.sol_root_base + R] = torch.cholesky_solve(
            root_rhs[:R, None], cholesky_nan(Rsys))[:, 0]
    return sol


def back_substitute(sol, ys, Ws, plan: MLPlan):
    """The downward sweep: each level's interiors d = y - W d_sep from the
    levels above, top-down, into `sol` in place; then every group's
    tangent."""
    for lv in reversed(range(plan.L)):
        L = plan.levels[lv]
        d_int = ys[lv]
        if Ws[lv] is not None:
            d_int = d_int - (Ws[lv] @ sol[plan.l2sol[lv]][..., None])[..., 0]
        base = plan.sol_base[lv]
        sol[base:base + d_int.numel()] = d_int.reshape(-1)
    return {g: sol[gi] for g, gi in plan.delta_gather.items()}


def solve_ml(lin, plan: MLPlan, lam=0.0):
    """Exact (damped) normal-equations solve by L-level recursive Schur
    elimination; `lin` is a GaussianGraph, `lam` a float or a 0-dim tensor.
    A front or root that is not positive definite gives a NaN step (see
    solvers.cholesky_nan), which the LM loop rejects."""
    r0 = lin.batches[0].r
    lam = torch.as_tensor(lam, dtype=r0.dtype, device=r0.device)
    fronts, rhs, root_sys, root_rhs = assemble(lin, plan)
    ys, Ws = [], []
    for lv in range(plan.L):
        y, W = eliminate_level(lv, fronts, rhs, root_sys, root_rhs, plan, lam)
        ys.append(y)
        Ws.append(W)
    sol = solve_root(root_sys, root_rhs, plan, lam)
    return back_substitute(sol, ys, Ws, plan)
