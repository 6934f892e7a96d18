"""Symbolic elimination: structure-only analysis of factor graphs.

Reference parity: gtsam/symbolic/ (SURVEY.md §2.3) — SymbolicFactorGraph,
SymbolicConditional, symbolic Bayes net/tree: compute the elimination
structure (conditional frontal/separator sets, fill-in, clique tree) without
numerics. Used to inspect/plan orderings; the numeric engines (schur.py)
consume the partition-based plans, and `min_degree_order` from native/
provides the fill-reducing ordering.

JAX counterpart: gtsam_personal_tpu/inference/symbolic.py (all of it). Host
Python and numpy over the port's native/ ordering library.
"""

from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from gtsam_personal_tpu_torch import native


class SymbolicFactorGraph:
    """Factors are just key sets (reference: SymbolicFactor)."""

    def __init__(self, factors: Sequence[Sequence[int]] = ()):
        self.factors: List[frozenset] = [frozenset(f) for f in factors]

    def add(self, *keys: int):
        self.factors.append(frozenset(keys))
        return self

    def keys(self) -> List[int]:
        out: Set[int] = set()
        for f in self.factors:
            out |= f
        return sorted(out)

    def eliminate(self, ordering: Sequence[int]):
        """Sequential symbolic elimination -> SymbolicBayesNet
        (frontal, parents) list + fill statistics."""
        factors = [set(f) for f in self.factors]
        conditionals: List[Tuple[int, frozenset]] = []
        fill = 0
        for v in ordering:
            involved = [f for f in factors if v in f]
            if not involved:
                conditionals.append((v, frozenset()))
                continue
            factors = [f for f in factors if v not in f]
            joined: Set[int] = set()
            for f in involved:
                joined |= f
            joined.discard(v)
            # fill-in: separator pairs not previously connected
            fill += max(0, len(joined) * (len(joined) - 1) // 2
                        - sum(len(f) * (len(f) - 1) // 2 for f in involved))
            conditionals.append((v, frozenset(joined)))
            if joined:
                factors.append(set(joined))
        return SymbolicBayesNet(conditionals), fill

    def default_ordering(self, constrained_last: Sequence[int] = (),
                         constrained_first: Sequence[int] = ()) -> List[int]:
        """Fill-reducing ordering via the native minimum-degree code
        (reference: Ordering::Colamd). `constrained_last` keys are forced to
        the end of the ordering and `constrained_first` to the front, each
        min-degree internally (reference: Ordering::ColamdConstrainedLast /
        ColamdConstrainedFirst, inference/Ordering.h:112-139 — e.g. ISAM2
        eliminates new keys last)."""
        keys = self.keys()
        remap = {k: i for i, k in enumerate(keys)}
        n = len(keys)
        adj: List[Set[int]] = [set() for _ in range(n)]
        for f in self.factors:
            ks = [remap[k] for k in f]
            for a in ks:
                for b in ks:
                    if a != b:
                        adj[a].add(b)
        indptr = np.zeros(n + 1, dtype=np.int64)
        indices = []
        for i in range(n):
            indptr[i + 1] = indptr[i] + len(adj[i])
            indices.extend(sorted(adj[i]))
        indices = np.asarray(indices, dtype=np.int64)
        if constrained_last or constrained_first:
            group = np.ones(n, dtype=np.int64)
            for k in constrained_first:
                group[remap[k]] = 0
            for k in constrained_last:
                group[remap[k]] = 2
            perm = native.min_degree_order_grouped(indptr, indices, group)
        else:
            perm = native.min_degree_order(indptr, indices)
        return [keys[int(p)] for p in perm]


class SymbolicBayesNet:
    """List of (frontal, parents) — the structure of sequential elimination."""

    def __init__(self, conditionals: List[Tuple[int, frozenset]]):
        self.conditionals = conditionals

    def __len__(self):
        return len(self.conditionals)

    def parents(self, v: int) -> frozenset:
        for f, p in self.conditionals:
            if f == v:
                return p
        raise KeyError(v)

    def clique_tree(self) -> List[Tuple[frozenset, int]]:
        """Merge conditionals into cliques (frontal+parents supersets) — the
        symbolic Bayes-tree structure (reference: SymbolicBayesTree). Returns
        (clique key set, parent clique index or -1), leaves-last."""
        cliques: List[Set[int]] = []
        parent_of: List[int] = []
        owner: Dict[int, int] = {}
        for f, ps in reversed(self.conditionals):  # roots first
            scope = {f} | set(ps)
            # attach to the clique owning all parents if it subsumes them
            host = -1
            if ps:
                cand = owner.get(next(iter(ps)))
                if cand is not None and ps <= cliques[cand]:
                    host = cand
            if host >= 0 and ps == cliques[host] & ps and len(cliques[host] | scope) <= len(cliques[host]) + 1 and ps <= cliques[host]:
                cliques[host] |= scope
                owner[f] = host
            else:
                cliques.append(set(scope))
                parent_of.append(host if host >= 0 else
                                 (owner.get(next(iter(ps)), -1) if ps else -1))
                owner[f] = len(cliques) - 1
        return [(frozenset(c), p) for c, p in zip(cliques, parent_of)]
