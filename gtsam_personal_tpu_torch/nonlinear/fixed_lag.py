"""Fixed-lag smoother: sliding-window optimization with exact
marginalization.

JAX counterpart: gtsam_personal_tpu/nonlinear/fixed_lag.py (all of it;
reference: BatchFixedLagSmoother, nonlinear/BatchFixedLagSmoother.h).
Variables carry user timestamps; `update()` adds factors and values,
optimizes again, and marginalizes every variable older than `lag` into a
dense Gaussian prior on its Markov blanket (linear/marginal.py). Factors
wholly inside the marginalized set are consumed by the prior; the
estimates of marginalized variables are frozen at their last smoothed
value.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.marginal import marginalize
from gtsam_personal_tpu_torch.nonlinear import optimizers


class FixedLagSmoother:
    def __init__(self, lag: float, params: Optional[optimizers.Params] = None):
        self.lag = lag
        self.params = params or optimizers.Params(max_iterations=10)
        self.batches: List[FactorBatch] = []
        self.values: Optional[Values] = None
        self.timestamps: Dict[Tuple[str, int], float] = {}
        self.frozen: Dict[str, Dict[int, np.ndarray]] = {}

    # -- public API (BatchFixedLagSmoother::update) -------------------------
    def update(self, new_batches: Sequence[FactorBatch],
               new_values: Optional[Values] = None,
               timestamps: Optional[Dict[Tuple[str, int], float]] = None):
        if new_values is not None:
            self.values = _merge_values(self.values, new_values)
        if timestamps:
            self.timestamps.update(timestamps)
        self.batches.extend(new_batches)

        res = optimizers.optimize_lm(FactorGraph(self.batches), self.values,
                                     self.params)
        self.values = res.values

        self._marginalize_old()
        return res

    def estimate(self) -> Values:
        return self.values

    def frozen_estimate(self, group: str, i: int):
        return self.frozen.get(group, {}).get(i)

    # -- internals -----------------------------------------------------------
    def _marginalize_old(self):
        if not self.timestamps:
            return
        horizon = max(self.timestamps.values()) - self.lag
        old = [k for k, t in self.timestamps.items() if t < horizon]
        if not old:
            return
        marg: Dict[str, List[int]] = {}
        for g, i in old:
            marg.setdefault(g, []).append(i)
        remaining, marginal, _ = marginalize(
            FactorGraph(self.batches), self.values, marg)
        self.batches = list(remaining.batches)
        if marginal is not None:
            self.batches.append(marginal)
        for g, i in old:
            self.frozen.setdefault(g, {})[i] = \
                self.values[g][i].cpu().numpy()
            del self.timestamps[(g, i)]
        # the marginalized variables stay in the Values tensors (dense
        # storage), but no factor refers to them any more: their tangent
        # columns are inert (zero gradient, unit damped diagonal)


def _merge_values(a: Optional[Values], b: Values) -> Values:
    """a with the rows of b beyond a's length appended, group by group."""
    if a is None:
        return b
    blocks = dict(a.blocks)
    for g, arr in b.blocks.items():
        if g in blocks:
            n_old = blocks[g].shape[0]
            if arr.shape[0] > n_old:
                blocks[g] = torch.cat([blocks[g], arr[n_old:]], dim=0)
        else:
            blocks[g] = arr
    return Values(blocks)
