"""Factor graph as structure-of-arrays batches.

JAX counterpart: gtsam_personal_tpu/core/graph.py (all of it; reference:
gtsam/inference/FactorGraph.h:57). All factors of one type form a
`FactorBatch` whose measurement and index tensors have leading dimension K;
residuals of the whole batch evaluate as one `torch.func.vmap` over the
single-factor residual function.

`graph_from_numpy` builds a graph on a device from plain arrays and Python
values, which is how a graph of another array package is carried across.
"""

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.noise import (NoiseModel,
                                                   error as noise_error)


class FactorBatch:
    """K structurally identical factors.

    residual_fn(xs, meas) -> [rdim]: a pure function of ONE factor's variable
    points (a tuple, one per slot) and one measurement slice (a dict of
    tensors without the leading K). It must not branch in Python on a
    tensor's value: it runs under `torch.func.vmap` and `jacfwd`."""

    def __init__(self, name: str, residual_fn: Callable,
                 groups: Tuple[str, ...], rdim: int,
                 idx: torch.Tensor, meas: Dict[str, torch.Tensor],
                 noise: NoiseModel, sign: float = 1.0):
        self.name = name
        self.residual_fn = residual_fn
        self.groups = tuple(groups)
        self.rdim = rdim
        self.idx = idx            # int64 [K, nslots]
        self.meas = meas          # dict of tensors, leading K
        self.noise = noise
        # sign = -1.0 makes the batch an AntiFactor: its linearized
        # contribution and its error are subtracted, which cancels an
        # identical +1 batch (reference: slam/AntiFactor.h:97).
        self.sign = float(sign)

    @property
    def size(self):
        return self.idx.shape[0]

    def gather_points(self, values: Values):
        return tuple(values[g][self.idx[:, s]]
                     for s, g in enumerate(self.groups))

    def residuals(self, values: Values):
        return torch.func.vmap(self.residual_fn)(self.gather_points(values),
                                                 self.meas)

    def error(self, values: Values):
        return self.sign * noise_error(self.noise, self.residuals(values))

    def negated(self) -> "FactorBatch":
        """AntiFactor wrapper (reference: slam/AntiFactor.h): the same batch
        with the opposite sign."""
        return FactorBatch(self.name + "_anti", self.residual_fn, self.groups,
                           self.rdim, self.idx, self.meas, self.noise,
                           sign=-self.sign)

    def __repr__(self):
        return (f"FactorBatch({self.name}, K={self.idx.shape[0]}, "
                f"groups={self.groups})")


class FactorGraph:
    """A list of factor batches (the whole nonlinear factor graph)."""

    def __init__(self, batches: Sequence[FactorBatch]):
        self.batches = list(batches)

    def error(self, values: Values):
        """Total error 0.5 sum ||whitened residual||^2 (+ robust losses), a
        0-dim tensor where the values live (reference:
        NonlinearFactorGraph::error)."""
        first = next(iter(values.blocks.values()))
        total = first.new_zeros(())
        for b in self.batches:
            total = total + b.error(values)
        return total

    @property
    def num_factors(self):
        return sum(b.size for b in self.batches)

    def __repr__(self):
        return "FactorGraph(\n  %s\n)" % "\n  ".join(map(repr, self.batches))


def _noise_from_numpy(kind, data, robust, k, device, dtype) -> NoiseModel:
    def t(a):
        return None if a is None else torch.tensor(
            np.asarray(a), dtype=dtype, device=device)
    return NoiseModel(kind, t(data), robust, t(k))


class GraphBuilder:
    """Collects factors one by one on the host (as the reference's
    `graph.add(...)` does); `build()` then stacks them into batches keyed by
    (name, groups, rdim, noise kind, robust kind)."""

    def __init__(self):
        self._factors: Dict[tuple, dict] = {}

    def add(self, name: str, residual_fn: Callable, groups: Sequence[str],
            rdim: int, idx: Sequence[int], meas: dict, noise_data: dict):
        """meas: {name: array} of one factor; noise_data: {'kind', 'data',
        'robust', 'k'} with this factor's arrays."""
        key = (name, tuple(groups), rdim, noise_data["kind"],
               noise_data.get("robust", "none"))
        slot = self._factors.setdefault(key, {
            "residual_fn": residual_fn, "idx": [], "meas": [],
            "noise_data": [], "noise_k": [],
        })
        slot["idx"].append(np.asarray(idx, dtype=np.int64))
        slot["meas"].append(meas)
        slot["noise_data"].append(noise_data.get("data"))
        slot["noise_k"].append(noise_data.get("k"))

    def build(self, *, device, dtype) -> FactorGraph:
        batches = []
        for (name, groups, rdim, kind, rob), slot in self._factors.items():
            idx = torch.tensor(np.stack(slot["idx"]), device=device)
            meas = {
                key: torch.tensor(np.stack([np.asarray(m[key])
                                            for m in slot["meas"]]),
                                  dtype=dtype, device=device)
                for key in slot["meas"][0]}
            nm = _noise_from_numpy(
                kind, None if kind == "unit" else np.stack(slot["noise_data"]),
                rob, None if rob == "none" else np.stack(slot["noise_k"]),
                device, dtype)
            batches.append(FactorBatch(name, slot["residual_fn"], groups,
                                       rdim, idx, meas, nm))
        return FactorGraph(batches)


def graph_from_numpy(batches: Sequence[dict], residual_of: Callable, *,
                     device, dtype) -> FactorGraph:
    """A FactorGraph on `device` from what factor batches hold, as numpy
    arrays and plain Python values. Each entry of `batches` is a dict with
    `name`, `groups`, `rdim`, `idx` [K, nslots], `meas` {name: array [K,
    ...]}, `noise` {'kind', 'data', 'robust', 'k'} and, optionally, `sign`.
    `residual_of(name)` gives the residual function of the batch of that
    name (`prior_se2`, `between_se3`, ...): slam/factors.py:residual_by_name
    for the factors of this package."""
    out = []
    for b in batches:
        n = b["noise"]
        out.append(FactorBatch(
            b["name"], residual_of(b["name"]),
            tuple(b["groups"]), int(b["rdim"]),
            torch.tensor(np.asarray(b["idx"], dtype=np.int64), device=device),
            {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
             for k, v in b["meas"].items()},
            _noise_from_numpy(n["kind"], n.get("data"),
                              n.get("robust", "none"), n.get("k"), device,
                              dtype),
            sign=b.get("sign", 1.0)))
    return FactorGraph(out)
