"""Variable marginalization -> dense Gaussian marginal prior factors.

JAX counterpart: gtsam_personal_tpu/linear/marginal.py (all of it). The
capability behind the reference's fixed-lag smoothing
(nonlinear/BatchFixedLagSmoother marginalize), ISAM2::marginalizeLeaves
(ISAM2.h:199) and Marginals (nonlinear/Marginals.h): eliminate a subset of
variables from the linearized system and keep the induced Gaussian prior on
their Markov blanket, anchored at the linearization point.

The marginal factor is
  r(x) = S xi(x) + r0,   xi(x) = concat_s local(anchor_s, x_s)
with S^T S = Lambda (the marginal information) and S^T r0 = g_marg, so its
Gauss-Newton contribution reproduces the Schur complement exactly.

The factors are linearized where the values live; the small dense Schur
complement runs on the host in numpy, as in the JAX package (marginalized
sets are small by construction in fixed-lag use).
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.linearize import linearize_batch
from gtsam_personal_tpu_torch.linear.noise import NoiseModel


def make_marginal_residual(groups: Tuple[str, ...]):
    ms = [manifolds.get(g) for g in groups]

    def residual(xs, meas):
        xi = torch.cat([m.local(meas[f"anchor{s}"], x)
                        for s, (m, x) in enumerate(zip(ms, xs))])
        return meas["sqrt_info"] @ xi + meas["r0"]

    residual.__name__ = "marginal_" + "_".join(groups)
    return residual


def _accumulate(H, gv, b: FactorBatch, values: Values, offs):
    """Add the batch's J^T J and J^T r (whitened, signed) into the dense
    H and gv at the columns `offs[(group, index)]`."""
    lb = linearize_batch(b, values)
    idx = b.idx.cpu().numpy()
    Js = [J.cpu().numpy() for J in lb.Js]
    r = lb.r.cpu().numpy()
    dims = [manifolds.get(g).dim for g in b.groups]
    for k in range(idx.shape[0]):
        cols = [offs[(g, int(idx[k, s]))] for s, g in enumerate(b.groups)]
        for s in range(len(b.groups)):
            gv[cols[s]:cols[s] + dims[s]] += lb.sign * (Js[s][k].T @ r[k])
            for t in range(len(b.groups)):
                H[cols[s]:cols[s] + dims[s],
                  cols[t]:cols[t] + dims[t]] += lb.sign * (Js[s][k].T
                                                          @ Js[t][k])


def marginalize(graph: FactorGraph, values: Values,
                marg: Dict[str, Sequence[int]]):
    """Marginalize the given variables out of `graph` at the linearization
    point `values`.

    Returns (remaining_graph, marginal_batch, boundary): marginal_batch is a
    single dense FactorBatch over the boundary variables (or None if the
    marginalized set is disconnected) and `boundary` lists its (group, index)
    slots. Factors that touch marginalized variables are removed from the
    remaining graph (their information lives on in the marginal factor)."""
    marg_sets = {g: set(map(int, ix)) for g, ix in marg.items()}

    keep_batches: List[FactorBatch] = []
    involved: List[Tuple[FactorBatch, np.ndarray]] = []
    for b in graph.batches:
        idx = b.idx.cpu().numpy()
        hit = np.zeros(idx.shape[0], dtype=bool)
        for s, g in enumerate(b.groups):
            if marg_sets.get(g):
                hit |= np.isin(idx[:, s], list(marg_sets[g]))
        if not hit.any():
            keep_batches.append(b)
            continue
        if not hit.all():
            keep_batches.append(_select(b, np.where(~hit)[0]))
        involved.append((b, np.where(hit)[0]))

    if not involved:
        return FactorGraph(keep_batches), None, []

    # the variables of the involved factors: marginalized first, then the
    # boundary, each in order of first appearance
    seen = set()
    marg_slots, bound_slots = [], []
    for b, rows in involved:
        idx = b.idx.cpu().numpy()
        for s, g in enumerate(b.groups):
            for i in np.unique(idx[rows, s]):
                key = (g, int(i))
                if key not in seen:
                    seen.add(key)
                    (marg_slots if int(i) in marg_sets.get(g, ())
                     else bound_slots).append(key)
    offs, off = {}, 0
    for key in marg_slots + bound_slots:
        offs[key] = off
        off += manifolds.get(key[0]).dim
    D = off
    Dm = sum(manifolds.get(g).dim for g, _ in marg_slots)

    H = np.zeros((D, D))
    gv = np.zeros(D)
    for b, rows in involved:
        _accumulate(H, gv, _select(b, rows), values, offs)

    # Schur complement onto the boundary
    Hmm = H[:Dm, :Dm] + 1e-9 * np.eye(Dm)
    Hmb = H[:Dm, Dm:]
    sol = np.linalg.solve(Hmm, np.concatenate([Hmb, gv[:Dm, None]], axis=1))
    Lam = H[Dm:, Dm:] - Hmb.T @ sol[:, :-1]
    gmarg = gv[Dm:] - Hmb.T @ sol[:, -1]
    Lam = 0.5 * (Lam + Lam.T)
    w, V = np.linalg.eigh(Lam)
    w = np.clip(w, 1e-12, None)
    S = np.diag(np.sqrt(w)) @ V.T           # S^T S = Lam
    r0 = np.linalg.solve(S.T, gmarg)

    if not bound_slots:
        return FactorGraph(keep_batches), None, []

    groups = tuple(g for g, _ in bound_slots)
    first = next(iter(values.blocks.values()))

    def dev(a):
        return torch.as_tensor(a, dtype=first.dtype, device=first.device)

    meas = {"sqrt_info": dev(S[None]), "r0": dev(r0[None])}
    for s, (g, i) in enumerate(bound_slots):
        meas[f"anchor{s}"] = values[g][i][None]
    marginal = FactorBatch(
        "marginal_" + "_".join(groups), make_marginal_residual(groups),
        groups, S.shape[0],
        torch.tensor([[i for _, i in bound_slots]], device=first.device),
        meas, NoiseModel("unit"))
    return FactorGraph(keep_batches), marginal, bound_slots


def graph_info_on(graph: FactorGraph, values: Values,
                  boundary: Sequence[Tuple[str, int]]):
    """Dense (Lambda, g) of `graph` Schur-complemented onto the ordered
    `boundary` slots (all other variables of the graph are eliminated), as
    numpy arrays. Boundary slots that the graph never touches get zero rows
    and columns. Used for summarized-factor exchange (concurrent filter and
    smoother, reference: ConcurrentBatchSmoother::getSummarizedFactors)."""
    offs: Dict[Tuple[str, int], int] = {}
    off = 0
    for g, i in boundary:
        offs[(g, int(i))] = off
        off += manifolds.get(g).dim
    Db = off
    for b in graph.batches:
        idx = b.idx.cpu().numpy()
        for s, g in enumerate(b.groups):
            for i in np.unique(idx[:, s]):
                key = (g, int(i))
                if key not in offs:
                    offs[key] = off
                    off += manifolds.get(g).dim
    D = off

    H = np.zeros((D, D))
    gv = np.zeros(D)
    for b in graph.batches:
        _accumulate(H, gv, b, values, offs)

    if D == Db:
        return H, gv
    Hbi = H[:Db, Db:]
    Hii = H[Db:, Db:] + 1e-9 * np.eye(D - Db)
    sol = np.linalg.solve(Hii, np.concatenate([Hbi.T, gv[Db:, None]], axis=1))
    Lam = H[:Db, :Db] - Hbi @ sol[:, :-1]
    g_out = gv[:Db] - Hbi @ sol[:, -1]
    return 0.5 * (Lam + Lam.T), g_out


def _select(b: FactorBatch, rows: np.ndarray) -> FactorBatch:
    """The factors `rows` of a batch; noise data that the whole batch shares
    (no leading K axis) stays as it is."""
    rows = torch.as_tensor(rows, dtype=torch.int64, device=b.idx.device)
    noise = b.noise
    data, k = noise.data, noise.k
    if data is not None and data.shape[0] == b.size:
        data = data[rows]
    if k is not None and k.dim() >= 1 and k.shape[0] == b.size:
        k = k[rows]
    return FactorBatch(b.name, b.residual_fn, b.groups, b.rdim, b.idx[rows],
                       {mk: mv[rows] for mk, mv in b.meas.items()},
                       NoiseModel(noise.kind, data, noise.robust, k),
                       sign=b.sign)
