"""Two-level partitioned Schur elimination: the sparse direct solve.

JAX counterpart: gtsam_personal_tpu/linear/schur.py:SchurPlan, make_plan,
schur_values, solve_partitioned (lines 68-411; reference: the multifrontal
elimination of inference/ClusterTree-inst.h:286-301). A two-level
nested-dissection structure is computed on the host
(inference/partition.py) and executed as batched dense linear algebra:

  1. assemble the per-part dense frontal matrices
     F_k = [[A_k, B_k], [B_k^T, C_k]] over interior + local-separator columns
     with one flat scatter-add per destination (reference: HessianFactor
     gather/assemble, linear/HessianFactor.cpp:458);
  2. batched Cholesky of all interiors at once (reference: choleskyPartial,
     base/cholesky.h:62);
  3. extend-add the Schur complements C_k - B_k^T A_k^{-1} B_k into the
     global reduced separator system;
  4. dense solve of the reduced system, then batched back-substitution.

All index plumbing is computed once per graph STRUCTURE on the host and kept
as int64 tensors on the device where the graph's index tensors live; flat
indices are int64, so their range sets no limit on the problem size. The
numeric path sees only fixed-shape gathers and scatters. The feature-major
`FMGraph` input of the JAX package is not taken here.
"""

from typing import Dict

import numpy as np
import torch

from gtsam_personal_tpu_torch import native
from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.inference.partition import (Partition,
                                                          batch_vids,
                                                          partition_graph)
from gtsam_personal_tpu_torch.linear.solvers import cholesky_nan


def _exclusive_cumsum(d):
    return np.cumsum(d) - d


class SchurPlan:
    """Static elimination plan for one graph structure and one partition.

    The tables equal the JAX plan's (`asm`, `l2g`, `ea_buckets`, `sol_maps`);
    they are built with numpy operations over whole batches instead of
    per-factor Python loops, and the per-factor column table is built once.
    """

    def __init__(self, graph, counts: Dict[str, int], partition: Partition):
        vi = partition.vi
        part_of = partition.part_of
        p = partition.num_parts
        nv = vi.num_vars
        dims = vi.dims
        device = graph.batches[0].idx.device
        self.p = p
        self.counts = dict(counts)

        # ---- interior layout: per part, local column offsets ----
        int_off = np.full(nv, -1, dtype=np.int64)   # start col in its front
        D = np.zeros(p, dtype=np.int64)
        for k, part in enumerate(partition.parts):
            int_off[part] = _exclusive_cumsum(dims[part])
            D[k] = dims[part].sum()
        self.D_max = int(D.max()) if p else 0
        self.D = D

        # ---- global separator layout ----
        sep = partition.separator
        sep_off = np.full(nv, -1, dtype=np.int64)
        sep_off[sep] = _exclusive_cumsum(dims[sep])
        self.S_dim = int(dims[sep].sum())
        self.sep = sep

        # ---- per-factor classification and local separator sets ----
        # keys = part * nv + vid of every separator variable that a factor
        # of that part touches: sorted by part, then by vid, which is the
        # order of the part's local separator columns
        batch_meta, keys = [], [np.zeros(0, dtype=np.int64)]
        for b in graph.batches:
            vids = batch_vids(b, vi)                    # [K, S]
            parts_s = part_of[vids]                     # -1 = separator
            # raises if a factor spans two interiors
            fpart = native.classify_factors(vids, part_of)
            batch_meta.append((vids, parts_s, fpart))
            on_sep = (fpart[:, None] >= 0) & (parts_s < 0)
            keys.append((fpart[:, None] * nv + vids)[on_sep])
        keys = np.unique(np.concatenate(keys))
        key_part, key_dim = keys // nv, dims[keys % nv]
        run = _exclusive_cumsum(key_dim)
        # local col offset (after D_max) = dims summed over the part's
        # earlier keys
        key_lo = run - run[np.searchsorted(key_part, key_part)]
        sd = np.bincount(key_part, weights=key_dim,
                         minlength=p).astype(np.int64)
        self.sd_max = int(sd.max()) if p else 0
        self.m = self.D_max + self.sd_max

        # local -> global separator flat map [p, sd_max], padding -> S_dim
        l2g = np.full((p, self.sd_max), self.S_dim, dtype=np.int64)
        rep = np.repeat(np.arange(keys.size), key_dim)
        j = np.arange(rep.size) - run[rep]
        l2g[key_part[rep], key_lo[rep] + j] = sep_off[keys[rep] % nv] + j

        def front_columns(vids, parts_s, fpart):
            """First column of each slot [K, S]: in its part's front for a
            factor with an interior variable, else in the separator system."""
            front = (fpart >= 0)[:, None]
            local_sep = front & (parts_s < 0)
            col_ls = np.zeros(vids.shape, dtype=np.int64)
            col_ls[local_sep] = self.D_max + key_lo[np.searchsorted(
                keys, (fpart[:, None] * nv + vids)[local_sep])]
            return np.where(front,
                            np.where(parts_s >= 0, int_off[vids], col_ls),
                            sep_off[vids])

        # ---- single-flat-scatter assembly plan ----
        # For the fixed device-side order of values (batches -> slot pairs
        # -> k, i, j; see schur_values) the flat target of every
        # Hessian-block and right-hand-side element.
        m = self.m
        Sfw = self.S_dim + 1  # separator frame width (row/col S = padding)
        fronts_idx, rhs_idx, ssys_idx, srhs_idx = [], [], [], []
        self.batch_plans = []
        for b, (vids, parts_s, fpart) in zip(graph.batches, batch_meta):
            nslots = vids.shape[1]
            bdims = [manifolds.get(g).dim for g in b.groups]
            front_rows = np.where(fpart >= 0)[0]
            sep_rows = np.where(fpart < 0)[0]
            self.batch_plans.append({"front_sel": front_rows,
                                     "sep_sel": sep_rows})
            col = front_columns(vids, parts_s, fpart)
            fp = fpart[front_rows]
            for s in range(nslots):
                rows_f = col[front_rows, s, None] + np.arange(bdims[s])
                rhs_idx.append((fp[:, None] * m + rows_f).ravel())
                rows_s = col[sep_rows, s, None] + np.arange(bdims[s])
                srhs_idx.append(rows_s.ravel())
                for t in range(nslots):
                    cols_f = col[front_rows, t, None] + np.arange(bdims[t])
                    fronts_idx.append((fp[:, None, None] * (m * m)
                                       + rows_f[:, :, None] * m
                                       + cols_f[:, None, :]).ravel())
                    cols_s = col[sep_rows, t, None] + np.arange(bdims[t])
                    ssys_idx.append((rows_s[:, :, None] * Sfw
                                     + cols_s[:, None, :]).ravel())

        def cat(xs):
            return np.concatenate(xs) if xs else np.zeros(0, np.int64)
        self.asm = {"fronts": cat(fronts_idx), "rhs": cat(rhs_idx),
                    "ssys": cat(ssys_idx), "srhs": cat(srhs_idx)}

        # ---- live-size-bucketed extend-add plan ----
        # A padded [p, sd_max^2] extend-add scatters mostly dead elements;
        # bucket the parts by live local-separator size (8 quantile buckets)
        # and scatter only each bucket's [pb, sdb, sdb] slab. Dead in-bucket
        # entries carry zero values and target the padding row/col S.
        order = np.argsort(-sd)
        nbuckets = min(8, p)
        self.ea_buckets = []
        bounds = np.linspace(0, p, nbuckets + 1).astype(int)
        for bi in range(nbuckets):
            ids = order[bounds[bi]:bounds[bi + 1]]
            if ids.size == 0:
                continue
            sdb = int(max(int(sd[ids].max()), 1))
            l2g_b = l2g[ids][:, :sdb]  # [pb, sdb], dead -> S_dim
            self.ea_buckets.append({
                "ids": ids, "sdb": sdb,
                "tgt": (l2g_b[:, :, None] * Sfw + l2g_b[:, None, :]).ravel(),
                "tgt_rhs": l2g_b.ravel(),
            })

        # ---- solution maps: tangent dict <- (front rows | sep rows) ----
        self.sol_maps = {}
        for g in sorted(counts):
            v = vi.vid(g, np.arange(counts[g]))
            in_sep = part_of[v] < 0
            self.sol_maps[g] = {
                "part": np.where(in_sep, 0, part_of[v]),
                "row": np.where(in_sep, 0, int_off[v]),
                "in_sep": in_sep,
                "sep_pos": np.where(in_sep, sep_off[v], 0),
                "dim": manifolds.get(g).dim,
            }

        # rows of the padded interior blocks beyond a part's own size
        self.pad_mask = np.arange(self.D_max)[None, :] >= D[:, None]
        self.l2g = l2g
        self._to_device(device)

    def _to_device(self, device):
        def move(container, keys):
            for k in keys:
                container[k] = torch.as_tensor(container[k], device=device)
        move(self.__dict__, ("l2g", "pad_mask"))
        for bp in self.batch_plans:
            move(bp, ("front_sel", "sep_sel"))
        move(self.asm, ("fronts", "rhs", "ssys", "srhs"))
        for eb in self.ea_buckets:
            move(eb, ("ids", "tgt", "tgt_rhs"))
        for smap in self.sol_maps.values():
            move(smap, ("part", "row", "in_sep", "sep_pos"))

    def stats(self):
        return {"p": self.p, "D_max": self.D_max, "sd_max": self.sd_max,
                "S_dim": self.S_dim, "front_size": self.m}


def make_plan(graph, counts, max_part_size=256) -> SchurPlan:
    part = partition_graph(graph, counts, max_part_size)
    return SchurPlan(graph, counts, part)


def schur_values(lin, plan: SchurPlan):
    """Assembly VALUES (fcat, rcat, scat, srcat) for the plan's flat-scatter
    targets, in the fixed order batches -> slot pairs -> k-major."""
    fvals, rvals, svals, srvals = [], [], [], []
    for b, bp in zip(lin.batches, plan.batch_plans):
        nslots = len(b.groups)
        fsel, ssel = bp["front_sel"], bp["sep_sel"]
        Jf = [b.Js[s][fsel] for s in range(nslots)]
        Js_ = [b.Js[s][ssel] for s in range(nslots)]
        rf, rs = b.r[fsel], b.r[ssel]
        for s in range(nslots):
            rvals.append(-torch.einsum("kij,ki->kj", Jf[s], rf).reshape(-1))
            srvals.append(-torch.einsum("kij,ki->kj", Js_[s],
                                        rs).reshape(-1))
            for t in range(nslots):
                fvals.append(torch.einsum("kij,kil->kjl", Jf[s],
                                          Jf[t]).reshape(-1))
                svals.append(torch.einsum("kij,kil->kjl", Js_[s],
                                          Js_[t]).reshape(-1))
    return tuple(torch.cat(xs) for xs in (fvals, rvals, svals, srvals))


def assemble(values, plan: SchurPlan):
    """From `schur_values`' four value vectors: the per-part fronts
    [p, m, m], their right-hand sides [p, m], and the separator-only
    factors' system ((S+1)^2 flat, row/col S = padding) and right-hand side
    [S+1]: one flat scatter-add per destination."""
    fcat, rcat, scat, srcat = values
    r0 = fcat
    p, m, Sfw = plan.p, plan.m, plan.S_dim + 1
    fronts = r0.new_zeros(p * m * m).index_add_(
        0, plan.asm["fronts"], fcat).view(p, m, m)
    rhs = r0.new_zeros(p * m).index_add_(0, plan.asm["rhs"], rcat).view(p, m)
    ssys = r0.new_zeros(Sfw * Sfw).index_add_(0, plan.asm["ssys"], scat)
    srhs = r0.new_zeros(Sfw).index_add_(0, plan.asm["srhs"], srcat)
    return fronts, rhs, ssys, srhs


def factor_interiors(fronts, plan: SchurPlan, lam):
    """Batched Cholesky of the damped interior blocks A_k + lam I. Unused
    interior rows of a part smaller than D_max get an identity diagonal."""
    Dm = plan.D_max
    A = fronts[:, :Dm, :Dm].clone()
    A.diagonal(dim1=-2, dim2=-1).add_(
        torch.where(plan.pad_mask, torch.ones_like(lam), lam))
    return cholesky_nan(A)


def eliminate_interiors(chol, fronts, rhs, plan: SchurPlan):
    """y = A^{-1} g and, where there is a separator, W = A^{-1} B with the
    Schur complements C - B^T W and their right-hand sides g_s - B^T y."""
    Dm = plan.D_max
    y = torch.cholesky_solve(rhs[:, :Dm, None], chol)[..., 0]
    if plan.sd_max == 0:
        return y, None, None, None
    B = fronts[:, :Dm, Dm:]
    Bt = B.transpose(-1, -2)
    W = torch.cholesky_solve(B, chol)                  # [p, Dm, sdm]
    schur = fronts[:, Dm:, Dm:] - Bt @ W
    rhs_s = rhs[:, Dm:] - (Bt @ y[..., None])[..., 0]
    return y, W, schur, rhs_s


def extend_add(ssys, srhs, schur, rhs_s, plan: SchurPlan):
    """Add the parts' Schur complements into the separator system, in place:
    live-size-bucketed flat scatters (dead entries are exact zeros and land
    on the padding row/col S)."""
    for eb in plan.ea_buckets:
        sdb = eb["sdb"]
        ssys.index_add_(0, eb["tgt"],
                        schur[eb["ids"]][:, :sdb, :sdb].reshape(-1))
        srhs.index_add_(0, eb["tgt_rhs"],
                        rhs_s[eb["ids"]][:, :sdb].reshape(-1))


def solve_separator(ssys, srhs, plan: SchurPlan, lam):
    """Dense Cholesky solve of the damped reduced system; [S+1] with a zero
    in the padding slot."""
    S = plan.S_dim
    dsep_pad = srhs.new_zeros(S + 1)
    if S > 0:
        Sred = ssys.view(S + 1, S + 1)[:S, :S].clone()
        Sred.diagonal().add_(lam)
        dsep_pad[:S] = torch.cholesky_solve(srhs[:S, None],
                                            cholesky_nan(Sred))[:, 0]
    return dsep_pad


def back_substitute(y, W, dsep_pad, plan: SchurPlan):
    """Interior solutions d_int = y - W d_sep, then every variable's tangent
    from its front row or its separator position."""
    S = plan.S_dim
    if W is not None and S > 0:
        d_int = y - (W @ dsep_pad[plan.l2g][..., None])[..., 0]
    else:
        d_int = y
    delta = {}
    for g, smap in plan.sol_maps.items():
        offs = torch.arange(smap["dim"], device=y.device)
        from_front = d_int[smap["part"][:, None],
                           smap["row"][:, None] + offs]
        from_sep = dsep_pad[torch.clamp(smap["sep_pos"][:, None] + offs,
                                        max=S)]
        delta[g] = torch.where(smap["in_sep"][:, None], from_sep, from_front)
    return delta


def solve_partitioned(lin, plan: SchurPlan, lam=0.0):
    """Exact (damped) normal-equations solve by two-level Schur elimination.

    `lin` is a GaussianGraph ([K, r, d] blocks). The damping is lam * I on
    every tangent coordinate (identity damping, LM's non-diagonal mode);
    `lam` is a float or a 0-dim tensor on the device. A front or a reduced
    system that is not positive definite gives a NaN step (see
    solvers.cholesky_nan), which the LM loop rejects."""
    r0 = lin.batches[0].r
    lam = torch.as_tensor(lam, dtype=r0.dtype, device=r0.device)
    fronts, rhs, ssys, srhs = assemble(schur_values(lin, plan), plan)
    chol = factor_interiors(fronts, plan, lam)
    y, W, schur, rhs_s = eliminate_interiors(chol, fronts, rhs, plan)
    if W is not None:
        extend_add(ssys, srhs, schur, rhs_s, plan)
    dsep_pad = solve_separator(ssys, srhs, plan, lam)
    return back_substitute(y, W, dsep_pad, plan)
