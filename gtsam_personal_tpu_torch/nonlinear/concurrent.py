"""Concurrent filtering and smoothing.

JAX counterpart: gtsam_personal_tpu/nonlinear/concurrent.py (all of it;
reference: gtsam_unstable/nonlinear/ConcurrentFilteringAndSmoothing.h,
the ConcurrentBatchFilter / ConcurrentBatchSmoother pair): a fast short-lag
filter serves online estimates while a full smoother runs over the whole
history, and synchronization exchanges summarized information.

The filter is the fixed-lag smoother (short window, cheap updates); the
smoother is a periodic full batch LM over all the factors (it owns every
raw factor, so the filter needs to send it no summary). `synchronize()` is
the smoother-to-filter exchange: the filter's accumulated boundary prior is
REPLACED by the smoother branch's joint marginal information on the same
boundary variables (the full posterior's marginal less the Schur complement
of the filter's retained raw window factors, so nothing counts twice),
anchored at the smoothed estimates, and the smoothed estimates are pushed
into the window (reference: ConcurrentBatchSmoother::getSummarizedFactors
feeding ConcurrentBatchFilter).
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.marginal import (graph_info_on,
                                                      make_marginal_residual)
from gtsam_personal_tpu_torch.linear.noise import NoiseModel
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.fixed_lag import (FixedLagSmoother,
                                                          _merge_values)
from gtsam_personal_tpu_torch.nonlinear.marginals import Marginals


class ConcurrentFilterSmoother:
    def __init__(self, filter_lag: float = 5.0,
                 smoother_every: int = 20,
                 filter_params: Optional[optimizers.Params] = None,
                 smoother_params: Optional[optimizers.Params] = None):
        self.filter = FixedLagSmoother(
            filter_lag, filter_params or optimizers.Params(max_iterations=5))
        self.smoother_every = smoother_every
        self.smoother_params = smoother_params or optimizers.Params(
            max_iterations=30)
        self.all_batches: List[FactorBatch] = []
        self.all_values: Optional[Values] = None
        self._updates = 0
        self.smoother_result = None

    def update(self, new_batches, new_values=None, timestamps=None):
        """The fast path, a filter update; every `smoother_every` updates the
        full smoother runs and synchronizes."""
        self.all_batches.extend(new_batches)
        if new_values is not None:
            self.all_values = _merge_values(self.all_values, new_values)
        res = self.filter.update(new_batches, new_values, timestamps)
        self._updates += 1
        if self._updates % self.smoother_every == 0:
            self.run_smoother()
            self.synchronize()
        return res

    def run_smoother(self):
        init = self.all_values
        # warm start from the filter's current estimates where it has them
        blocks = dict(init.blocks)
        for g, arr in self.filter.values.blocks.items():
            if g in blocks and arr.shape[0] >= blocks[g].shape[0]:
                blocks[g] = arr[: blocks[g].shape[0]]
        self.smoother_result = optimizers.optimize_lm(
            FactorGraph(self.all_batches), Values(blocks),
            self.smoother_params)
        self.all_values = self.smoother_result.values
        return self.smoother_result

    def synchronize(self):
        """The smoother-to-filter summarized-factor exchange and estimate
        push (reference: ConcurrentFilteringAndSmoothing
        synchronization)."""
        if self.smoother_result is None:
            return
        sm = self.smoother_result.values

        # 1. replace the filter's accumulated marginal prior by the smoother
        # posterior's joint marginal on the same boundary slots
        boundary: List[Tuple[str, int]] = []
        kept: List[FactorBatch] = []
        for b in self.filter.batches:
            if b.name.startswith("marginal_"):
                idx = b.idx.cpu().numpy()
                for k in range(idx.shape[0]):
                    for s, g in enumerate(b.groups):
                        key = (g, int(idx[k, s]))
                        if key not in boundary:
                            boundary.append(key)
            else:
                kept.append(b)
        if boundary:
            # The summary carries ONLY smoother-branch information: the
            # filter keeps its raw window factors (`kept`), whose boundary
            # information must not appear in the summary too (it would
            # count twice: an overconfident, biased filter). Window-interior
            # variables are touched only by window factors and smoother-
            # interior ones only by smoother factors, so the full
            # posterior's boundary marginal splits additively:
            #   Lam_full(B) = Lam_smoother_branch(B) + Schur_B(kept window),
            # and the window term is subtracted.
            summary = _smoother_summary(
                FactorGraph(self.all_batches), sm, boundary,
                exclude=FactorGraph(kept) if kept else None)
            self.filter.batches = kept + [summary]

        # 2. push the smoothed estimates into the filter window
        blocks = dict(self.filter.values.blocks)
        for g, arr in sm.blocks.items():
            if g in blocks:
                n = min(arr.shape[0], blocks[g].shape[0])
                b = blocks[g].clone()
                b[:n] = arr[:n]
                blocks[g] = b
        self.filter.values = Values(blocks)

    def filtered_estimate(self) -> Values:
        return self.filter.estimate()

    def smoother_summary_on(self, boundary: List[Tuple[str, int]],
                            exclude: Optional[FactorGraph] = None):
        """The smoother's summarized factor on any boundary slots
        (reference: ConcurrentBatchSmoother::getSummarizedFactors). Pass
        `exclude` = the factors the receiver already holds raw, so that
        their information does not count twice."""
        if self.smoother_result is None:
            return None
        return _smoother_summary(FactorGraph(self.all_batches),
                                 self.smoother_result.values, boundary,
                                 exclude=exclude)

    def smoothed_estimate(self) -> Optional[Values]:
        return (None if self.smoother_result is None
                else self.smoother_result.values)


def _smoother_summary(graph: FactorGraph, values: Values,
                      boundary: List[Tuple[str, int]],
                      exclude: Optional[FactorGraph] = None) -> FactorBatch:
    """A dense Gaussian factor equal to the smoother branch's joint marginal
    information on `boundary`, anchored at the smoothed estimates.

    It is the full posterior's boundary marginal information less the
    Schur complement of the `exclude` graph (the filter's retained raw
    window factors) onto the same boundary: exact, because window-interior
    and smoother-interior variables are disjoint across the two branches.
    The linear term is -g_window(anchor): at the smoothed mode the full
    marginal gradient is zero, so the smoother branch's gradient is the
    negative of the window branch's (reference semantics:
    ConcurrentBatchSmoother::getSummarizedFactors). The dense algebra is
    numpy on the host, as in the JAX package."""
    cov = (Marginals(graph, values, damping=1e-9)
           .joint_marginal_covariance(boundary).cpu().numpy())
    Lam = np.linalg.inv(0.5 * (cov + cov.T))
    g_lin = np.zeros(Lam.shape[0])
    if exclude is not None and exclude.batches:
        Lam_w, g_w = graph_info_on(exclude, values, boundary)
        Lam = Lam - Lam_w
        g_lin = -g_w
    Lam = 0.5 * (Lam + Lam.T)
    w, V = np.linalg.eigh(Lam)
    w = np.clip(w, 1e-12, None)
    S = np.diag(np.sqrt(w)) @ V.T           # S^T S = Lam
    # r0 solves S^T r0 = g_lin; near-null directions of the (subtracted)
    # information are projected out rather than amplified
    good = w > 1e-9 * max(float(w.max()), 1.0)
    r0 = np.where(good, (V.T @ g_lin) / np.sqrt(w), 0.0)
    groups = tuple(g for g, _ in boundary)
    ref = values[groups[0]]

    def dev(a):
        return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)

    meas = {"sqrt_info": dev(S[None]), "r0": dev(r0[None])}
    for s, (g, i) in enumerate(boundary):
        meas[f"anchor{s}"] = values[g][i][None].to(ref.dtype)
    return FactorBatch(
        "marginal_" + "_".join(groups), make_marginal_residual(groups),
        groups, S.shape[0],
        torch.tensor([[i for _, i in boundary]], dtype=torch.int64,
                     device=ref.device),
        meas, NoiseModel("unit"))
