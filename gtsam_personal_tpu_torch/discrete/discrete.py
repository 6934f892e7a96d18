"""Discrete factor graphs: dense-table inference.

JAX counterpart: gtsam_personal_tpu/discrete/discrete.py (all of it;
reference: gtsam/discrete/, DecisionTreeFactor / TableFactor,
DiscreteConditional, DiscreteBayesNet, sum-product and max-product
elimination, DiscreteMarginals, DiscreteSearch-style best assignments).
The reference's ADDs (DecisionTree with merged leaves) compress sparsity on
CPUs; here a potential is a dense table contracted by broadcasting, exact
for the cardinalities these problems use.

Variables are integers with cardinalities; a factor holds `vars` (ordered)
and a dense `table` tensor with shape = their cardinalities. A table given
as an array goes to `device`, the card unless the caller names another;
a tensor keeps its own device. `factor_graph_from_numpy` builds a graph
from plain (vars, table) pairs, which is how a graph of the JAX package is
carried across.

`k_best` enumerates the full joint table, as the JAX package does: keep it
to about 20 binary variables. `DiscreteBayesNet.sample` draws from a
`torch.Generator`; its deterministic part, `sample_from_uniforms`, takes
one uniform per conditional (the JAX package's `jax.random.choice` with
probabilities is the same function of its uniform draw).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gtsam_personal_tpu_torch import config


def _table(table, device):
    if isinstance(table, torch.Tensor):
        return table if device is None else table.to(config.device(device))
    return torch.as_tensor(np.asarray(table),
                           device=config.device(device or "cuda"))


class DiscreteFactor:
    def __init__(self, vars: Sequence[int], table, device=None):
        self.vars = tuple(vars)
        self.table = _table(table, device)
        if self.table.dim() != len(self.vars):
            raise ValueError(f"table of {self.table.dim()} axes for "
                             f"{len(self.vars)} variables")

    def cardinality(self, v):
        return self.table.shape[self.vars.index(v)]

    def value(self, assignment: Dict[int, int]):
        idx = tuple(assignment[v] for v in self.vars)
        return self.table[idx]

    def __repr__(self):
        return (f"DiscreteFactor(vars={self.vars}, "
                f"shape={tuple(self.table.shape)})")


class DiscreteConditional(DiscreteFactor):
    """P(frontal | parents): table over (frontal, *parents), normalized over
    the frontal axis (reference: DiscreteConditional)."""

    def __init__(self, frontal: int, parents: Sequence[int], table,
                 device=None):
        super().__init__((frontal,) + tuple(parents), table, device)
        self.frontal = frontal
        self.parents = tuple(parents)


def _multiply(factors: Sequence[DiscreteFactor]) -> DiscreteFactor:
    """Product over the union domain via broadcasting."""
    all_vars: List[int] = []
    cards: Dict[int, int] = {}
    for f in factors:
        for v, c in zip(f.vars, f.table.shape):
            if v not in cards:
                all_vars.append(v)
                cards[v] = c
    shape = tuple(cards[v] for v in all_vars)
    first = factors[0].table
    dtype = first.dtype
    for f in factors[1:]:
        dtype = torch.promote_types(dtype, f.table.dtype)
    out = torch.ones(shape, dtype=dtype, device=first.device)
    for f in factors:
        # f's axes in their order of appearance in all_vars, then singleton
        # axes for broadcasting
        order = sorted(range(len(f.vars)),
                       key=lambda s: all_vars.index(f.vars[s]))
        t = f.table.permute(order)
        bshape = [1] * len(all_vars)
        for ax in order:
            bshape[all_vars.index(f.vars[ax])] = f.table.shape[ax]
        out = out * t.reshape(tuple(bshape))
    return DiscreteFactor(all_vars, out)


class DiscreteFactorGraph:
    def __init__(self, device="cuda"):
        self.device = device
        self.factors: List[DiscreteFactor] = []

    def add(self, vars, table):
        """Add a potential; an array table goes to the graph's device, a
        tensor keeps its own."""
        self.factors.append(DiscreteFactor(
            vars, table, None if isinstance(table, torch.Tensor)
            else self.device))
        return self

    def eliminate(self, ordering: Sequence[int], mode: str = "sum"):
        """Sequential elimination -> (DiscreteBayesNet, remaining factors).

        mode 'sum' = sum-product (posterior), 'max' = max-product (MPE)."""
        factors = list(self.factors)
        conditionals: List[DiscreteConditional] = []
        for v in ordering:
            involved = [f for f in factors if v in f.vars]
            if not involved:
                continue
            factors = [f for f in factors if v not in f.vars]
            prod = _multiply(involved)
            ax = prod.vars.index(v)
            rest = tuple(x for x in prod.vars if x != v)
            t = torch.movedim(prod.table, ax, 0)      # frontal axis first
            msg = t.sum(0) if mode == "sum" else t.amax(0)
            denom = torch.where(msg > 0, msg, torch.ones_like(msg))
            conditionals.append(DiscreteConditional(v, rest,
                                                    t / denom[None, ...]))
            factors.append(DiscreteFactor(rest, msg if rest
                                          else msg.reshape(())))
        return DiscreteBayesNet(conditionals), factors

    def optimize(self, ordering: Optional[Sequence[int]] = None
                 ) -> Dict[int, int]:
        """MPE assignment via max-product + backtracking (reference:
        DiscreteFactorGraph::optimize)."""
        if ordering is None:
            ordering = self.variables()
        bn, _ = self.eliminate(ordering, mode="max")
        return bn.argmax_back_substitute()

    def marginal(self, v: int) -> torch.Tensor:
        """Normalized marginal of one variable (reference:
        DiscreteMarginals)."""
        ordering = [u for u in self.variables() if u != v]
        _, remaining = self.eliminate(ordering, mode="sum")
        prod = _multiply([f for f in remaining if f.vars])
        ax = prod.vars.index(v)
        t = prod.table
        other = tuple(i for i in range(t.dim()) if i != ax)
        m = t.sum(other) if other else t
        return m / m.sum()

    def k_best(self, k: int) -> List[Tuple[Dict[int, int], float]]:
        """Top-k assignments by joint potential (reference: DiscreteSearch,
        discrete/DiscreteSearch.h), by exact enumeration over the joint
        domain, ordered on the host as the JAX package orders them."""
        prod = _multiply(self.factors)
        flat = prod.table.detach().cpu().numpy().reshape(-1)
        order = np.argsort(-flat)[:k]
        shape = tuple(prod.table.shape)
        out = []
        for f in order:
            idx = np.unravel_index(int(f), shape)
            out.append(({v: int(i) for v, i in zip(prod.vars, idx)},
                        float(flat[f])))
        return out

    def variables(self) -> List[int]:
        seen = []
        for f in self.factors:
            for v in f.vars:
                if v not in seen:
                    seen.append(v)
        return seen

    def evaluate(self, assignment: Dict[int, int]):
        out = 1.0
        for f in self.factors:
            out = out * float(f.value(assignment))
        return out


def factor_graph_from_numpy(factors: Sequence[Tuple[Sequence[int], object]],
                            *, device) -> DiscreteFactorGraph:
    """A graph on `device` from (vars, table) pairs of any array source
    (numpy, or `np.asarray` of the JAX package's factor tables)."""
    g = DiscreteFactorGraph(device)
    for vars_, table in factors:
        g.add(tuple(vars_), np.asarray(table))
    return g


class DiscreteBayesNet:
    def __init__(self, conditionals: List[DiscreteConditional]):
        self.conditionals = conditionals

    def argmax_back_substitute(self) -> Dict[int, int]:
        """Back-substitution for MPE: assign in reverse elimination
        order."""
        assignment: Dict[int, int] = {}
        for cond in reversed(self.conditionals):
            idx = tuple(assignment[p] for p in cond.parents)
            col = cond.table[(slice(None),) + idx]
            assignment[cond.frontal] = int(torch.argmax(col))
        return assignment

    def evaluate(self, assignment: Dict[int, int]):
        out = 1.0
        for cond in self.conditionals:
            idx = (assignment[cond.frontal],) + tuple(assignment[p]
                                                      for p in cond.parents)
            out *= float(cond.table[idx])
        return out

    def sample_from_uniforms(self, uniforms,
                             fixed: Optional[Dict[int, int]] = None
                             ) -> Dict[int, int]:
        """Ancestral sampling in reverse elimination order, conditional i
        (counted from the last) drawn by inverse CDF from uniforms[i] in
        [0, 1): the index where the cumulative probability first reaches
        total * (1 - u). A fixed variable keeps its value and uses no
        uniform."""
        assignment = dict(fixed or {})
        i = 0
        for cond in reversed(self.conditionals):
            if cond.frontal in assignment:
                continue
            idx = tuple(assignment[p] for p in cond.parents)
            probs = cond.table[(slice(None),) + idx]
            cum = torch.cumsum(probs / probs.sum(), 0)
            u = torch.as_tensor(uniforms[i], dtype=cum.dtype,
                                device=cum.device)
            r = cum[-1] * (1 - u)
            assignment[cond.frontal] = int(torch.searchsorted(cum, r[None]))
            i += 1
        return assignment

    def sample(self, generator: torch.Generator,
               fixed: Optional[Dict[int, int]] = None) -> Dict[int, int]:
        """One joint draw (reference: DiscreteBayesNet::sample), uniforms
        from `generator` on its device."""
        u = torch.rand(len(self.conditionals), generator=generator,
                       dtype=torch.float64, device=generator.device)
        return self.sample_from_uniforms(u, fixed)


def cpt(frontal: int, parents: Sequence[int], rows: Sequence[Sequence[float]],
        cards: Optional[Sequence[int]] = None, device=None
        ) -> DiscreteConditional:
    """Build a conditional from rows of probabilities, one row per parent
    assignment (row-major over parents): the analogue of the reference's
    Signature strings like "A|B=1/2 2/1" (discrete/Signature.h)."""
    rows = np.asarray(rows, dtype=np.float64)
    rows = rows / rows.sum(axis=-1, keepdims=True)
    card_f = rows.shape[-1]
    if parents:
        if cards is None:
            raise ValueError("parent cardinalities required")
        table = np.moveaxis(rows.reshape(tuple(cards) + (card_f,)), -1, 0)
    else:
        table = rows.reshape(card_f)
    return DiscreteConditional(frontal, parents, table, device)


def parse_signature(spec: str, frontal: int, parents: Sequence[int],
                    cards: Optional[Sequence[int]] = None, device=None):
    """Reference Signature-string CPT syntax (discrete/SignatureParser.cpp):
    rows separated by whitespace, each row's outcome weights separated by
    '/', e.g. P(D|B,E) as "9/1 2/8 3/7 1/9" (row-major over parents) or a
    prior as "4/6". Returns a DiscreteConditional via cpt()."""
    rows = [[float(v) for v in tok.split("/")] for tok in spec.split()]
    if len(rows) == 1 and not parents:
        return cpt(frontal, (), rows, device=device)
    if cards is None:
        raise ValueError("parent cardinalities required")
    expect = int(np.prod(list(cards)))
    if len(rows) != expect:
        raise ValueError(
            f"signature '{spec}' has {len(rows)} rows, parents need {expect}")
    return cpt(frontal, parents, rows, cards, device)
