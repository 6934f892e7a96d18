"""Hybrid discrete-continuous inference: Gaussian mixtures over factor graphs.

JAX counterpart: gtsam_personal_tpu/hybrid/hybrid.py (all of it;
reference: gtsam/hybrid/, HybridGaussianFactor, HybridNonlinearFactorGraph,
EliminateHybrid, HybridBayesNet::prune).

Hypotheses (discrete assignments) share one graph structure and differ only
in measurement values. The JAX package solves them in one `jax.vmap` of its
one-program LM; here `_solve_batch` solves them one after another with
nonlinear/optimizers.py:optimize_lm_jit, which gives each the answer the
vmapped loop gives it (that loop freezes each element once it is done).
One hypothesis alone goes through `optimize_lm`, as in the JAX package.
Two solvers sit on top:

- `solve`: exact enumeration of the joint discrete domain (a handful of
  mode variables);
- `solve_beam`: sequential per-mode-variable elimination with pruning
  during elimination (the reference's EliminateHybrid with in-elimination
  pruning, hybrid/HybridGaussianFactorGraph.h:106), O(#vars * max_leaves *
  card) continuous solves.

The discrete posterior follows from the per-hypothesis optimum energies
(leaf weights of HybridBayesNet); pruning keeps the top-k leaves.
`HybridSmoother` and `HybridISAM` are the incremental forms; `HybridISAM`
forks one ISAM2 engine per hypothesis with `ISAM2.clone`.

A `HybridFactor` is an ordinary FactorBatch whose measurement tensors carry
a leading MODES axis selected by a discrete variable assignment;
`hybrid_factor_from_numpy` builds one from the stacked arrays of the JAX
package's.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gtsam_personal_tpu_torch.core.graph import (FactorBatch, FactorGraph,
                                                 graph_from_numpy)
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear.noise import NoiseModel, log_det_whitener
from gtsam_personal_tpu_torch.nonlinear import optimizers
from gtsam_personal_tpu_torch.nonlinear.isam2 import ISAM2, ISAM2Params


def _solve_batch(graphs, warms, params):
    """Solve H structurally identical continuous problems. Returns (list of
    Values, np energies [H])."""
    if len(graphs) == 1:
        res = optimizers.optimize_lm(graphs[0], warms[0], params)
        return [res.values], np.asarray([res.error])
    out, errs = [], []
    for g, v in zip(graphs, warms):
        vals, err, _ = optimizers.optimize_lm_jit(g, v, params)
        out.append(vals)
        errs.append(float(err))
    return out, np.asarray(errs)


def _mergeable(b: FactorBatch):
    n = b.noise
    if n.robust != "none" or n.kind not in ("unit", "diag", "full"):
        return False
    return n.data is None or (n.data.dim() == (3 if n.kind == "full" else 2)
                              and n.data.shape[0] == b.size)


def _merge_batches(batches) -> List[FactorBatch]:
    """Batches of one residual function, groups and per-factor noise
    layout concatenated into one, at the place of the first: the same
    function, summed in another order. A graph of many one-factor batches
    (a stream adds them so) costs the JAX package one compile; here each
    batch would cost its own vmapped linearization a solve."""
    parts, slot = [], {}
    for b in batches:
        key = ((b.name, b.residual_fn, b.groups, b.rdim, b.noise.kind,
                b.sign, tuple(sorted(b.meas))) if _mergeable(b) else None)
        if key is not None and key in slot:
            parts[slot[key]].append(b)
            continue
        if key is not None:
            slot[key] = len(parts)
        parts.append([b])
    out = []
    for group in parts:
        b = group[0]
        if len(group) > 1:
            data = (None if b.noise.data is None else
                    torch.cat([g.noise.data for g in group]))
            b = FactorBatch(b.name, b.residual_fn, b.groups, b.rdim,
                            torch.cat([g.idx for g in group]),
                            {k: torch.cat([g.meas[k] for g in group])
                             for k in b.meas},
                            NoiseModel(b.noise.kind, data), sign=b.sign)
        out.append(b)
    return out


def _posterior(hypotheses, energy_of):
    es = np.asarray([energy_of(h) for h in hypotheses])
    w = np.exp(-(es - es.min()))
    w = w / w.sum()
    return {tuple(sorted(h[0].items())): float(wk)
            for h, wk in zip(hypotheses, w)}


class HybridFactor:
    """A factor whose measurement depends on a discrete mode variable.

    mode_var: discrete variable id; for each mode m the factor behaves like
    `batch` with measurements meas[m] (tensors with a leading [modes]
    axis)."""

    def __init__(self, batch: FactorBatch, mode_var: int, num_modes: int,
                 per_mode_noise: bool = None):
        self.batch = batch          # meas tensors: [modes, K, ...]
        self.mode_var = mode_var
        self.num_modes = num_modes
        # per-mode noise = data carries a leading [modes] axis. Inferred from
        # the shape when unambiguous; when K or rdim equals num_modes the
        # shape alone cannot tell per-mode from shared data, so the caller
        # must say.
        data = batch.noise.data
        if per_mode_noise is None:
            looks_per_mode = (data is not None and data.dim() >= 1
                              and data.shape[0] == num_modes)
            if looks_per_mode and (batch.idx.shape[0] == num_modes
                                   or batch.rdim == num_modes):
                raise ValueError(
                    "HybridFactor noise shape is ambiguous (leading axis == "
                    f"num_modes == K or rdim = {num_modes}); pass "
                    "per_mode_noise=True/False explicitly")
            per_mode_noise = looks_per_mode
        self.per_mode_noise = bool(per_mode_noise)

    def at_mode(self, m) -> FactorBatch:
        b = self.batch
        noise = b.noise
        if self.per_mode_noise:
            noise = NoiseModel(noise.kind, noise.data[m], noise.robust,
                               noise.k)
        return FactorBatch(b.name, b.residual_fn, b.groups, b.rdim, b.idx,
                           {k: v[m] for k, v in b.meas.items()}, noise,
                           sign=b.sign)

    def log_normalizer(self, m: int) -> float:
        """log|det W_m| when the noise is per-mode; 0 for shared noise,
        where the constant cancels across modes. Joins the hypothesis
        energy so modes with different noise are scored by true negative
        log-likelihood (reference: HybridGaussianFactor logNormalizers)."""
        if not self.per_mode_noise:
            return 0.0
        return log_det_whitener(self.at_mode(m).noise)


def hybrid_factor_from_numpy(batch: dict, residual_of, mode_var: int,
                             num_modes: int, *, device, dtype,
                             per_mode_noise: bool = None) -> HybridFactor:
    """A HybridFactor on `device` from the arrays of a batch (the dict of
    core/graph.py:graph_from_numpy, its `meas` arrays [modes, K, ...] and,
    for per-mode noise, its noise data [modes, ...])."""
    (fb,) = graph_from_numpy([batch], residual_of, device=device,
                             dtype=dtype).batches
    return HybridFactor(fb, mode_var, num_modes, per_mode_noise)


class HybridFactorGraph:
    """Continuous factors + hybrid (mode-dependent) factors + discrete
    priors."""

    def __init__(self):
        self.continuous: List[FactorBatch] = []
        self.hybrid: List[HybridFactor] = []
        self.discrete_priors: Dict[int, np.ndarray] = {}
        self._merged: Optional[List[FactorBatch]] = None

    def add_continuous(self, batch: FactorBatch):
        self.continuous.append(batch)
        self._merged = None

    def _graph(self, hybrid_batches) -> FactorGraph:
        """The continuous factors and the given hybrid batches, batches of
        one layout merged (_merge_batches)."""
        if self._merged is None:
            self._merged = _merge_batches(self.continuous)
        return FactorGraph(_merge_batches(self._merged
                                          + list(hybrid_batches)))

    def add_hybrid(self, hf: HybridFactor):
        self.hybrid.append(hf)

    def add_discrete_prior(self, var: int, probs):
        self.discrete_priors[var] = np.asarray(probs, dtype=np.float64)

    def mode_vars(self) -> List[int]:
        seen = []
        for hf in self.hybrid:
            if hf.mode_var not in seen:
                seen.append(hf.mode_var)
        return seen

    def _cards(self, vars_):
        return {v: max(hf.num_modes for hf in self.hybrid if hf.mode_var == v)
                for v in vars_}

    def assignments(self) -> List[Dict[int, int]]:
        """Enumerate the joint discrete domain."""
        vars_ = self.mode_vars()
        cards = self._cards(vars_)
        out = [dict()]
        for v in vars_:
            out = [{**a, v: m} for a in out for m in range(cards[v])]
        return out

    def graph_at(self, assignment: Dict[int, int]) -> FactorGraph:
        return self._graph(hf.at_mode(assignment[hf.mode_var])
                           for hf in self.hybrid)

    def solve(self, initial: Values,
              params: Optional[optimizers.Params] = None,
              prune_to: Optional[int] = None):
        """Optimize the continuous variables under every discrete assignment
        and return (best_values, best_assignment, posterior dict).

        posterior[a] ~ prior(a) * exp(-E*_a) with E*_a the optimum energy,
        the leaf weights HybridBayesNet computes; prune_to keeps the top k
        (HybridBayesNet::prune)."""
        params = params or optimizers.Params(max_iterations=25)
        assignments = self.assignments()
        graphs = [self.graph_at(a) for a in assignments]
        values_list, energies = _solve_batch(
            graphs, [initial] * len(graphs), params)
        energies = np.asarray([self._prior_energy(a, e)
                               for a, e in zip(assignments, energies)])
        order = np.argsort(energies)
        if prune_to is not None:
            order = order[:prune_to]
        w = np.exp(-(energies[order] - energies[order].min()))
        w = w / w.sum()
        posterior = {tuple(sorted(assignments[k].items())): float(wk)
                     for k, wk in zip(order, w)}
        best = int(order[0])
        return values_list[best], assignments[best], posterior

    def _prior_energy(self, assignment, e):
        e = float(e)
        for v, m in assignment.items():
            if v in self.discrete_priors:
                e -= float(np.log(max(self.discrete_priors[v][m], 1e-300)))
        for hf in self.hybrid:
            if hf.mode_var in assignment:
                e -= hf.log_normalizer(assignment[hf.mode_var])
        return e

    def solve_beam(self, initial: Values, max_leaves: int = 8,
                   params: Optional[optimizers.Params] = None):
        """Sequential per-mode-variable elimination with pruning during
        elimination (reference: EliminateHybrid,
        hybrid/HybridGaussianFactorGraph.h:106).

        Mode variables are introduced one at a time; each surviving
        hypothesis branches over the new variable's values, the continuous
        problems (the factors whose mode variables are assigned so far, plus
        all continuous factors) are solved warm-started from the parent,
        and the beam is pruned to `max_leaves`.

        Returns (best_values, best_assignment, posterior) like `solve`."""
        params = params or optimizers.Params(max_iterations=25)
        vars_ = self.mode_vars()
        cards = self._cards(vars_)
        beam = [({}, initial, 0.0)]
        for i, v in enumerate(vars_):
            assigned = set(vars_[: i + 1])
            active = [hf for hf in self.hybrid if hf.mode_var in assigned]
            cands = [({**a, v: m}, vals)
                     for a, vals, _ in beam for m in range(cards[v])]
            graphs = [self._graph(hf.at_mode(a[hf.mode_var])
                                  for hf in active)
                      for a, _ in cands]
            values_list, errs = _solve_batch(
                graphs, [w for _, w in cands], params)
            scored = sorted(
                [(a, vals, self._prior_energy(a, e))
                 for (a, _), vals, e in zip(cands, values_list, errs)],
                key=lambda t: t[2])
            beam = scored[:max_leaves]
        return beam[0][1], beam[0][0], _posterior(beam, lambda h: h[2])


class HybridSmoother:
    """Incremental hybrid inference with mixture pruning (reference:
    hybrid/HybridSmoother.h, HybridGaussianISAM; driven like the
    Hybrid_City10000.cpp example).

    Keeps at most `max_leaves` discrete hypotheses (partial assignments
    over the mode variables seen so far), each with a warm-started
    continuous estimate and its energy. Each `update` extends every
    surviving hypothesis with all values of the new mode variables,
    re-optimizes the continuous variables warm-started from the parent
    hypothesis, and prunes back to the top `max_leaves`
    (HybridBayesNet::prune(maxNrLeaves))."""

    def __init__(self, max_leaves: int = 8,
                 params: Optional[optimizers.Params] = None):
        self.max_leaves = max_leaves
        self.params = params or optimizers.Params(max_iterations=15)
        self.graph = HybridFactorGraph()
        # hypotheses: list of (assignment dict, Values or None, energy)
        self.hypotheses = [({}, None, 0.0)]

    def update(self, initial: Values, continuous=(), hybrids=()):
        """Add factors (continuous FactorBatches / HybridFactors) and refresh
        the pruned hypothesis set. `initial` supplies values for any new
        continuous variables (full-sized Values; existing estimates win)."""
        for b in continuous:
            self.graph.add_continuous(b)
        new_modes = []
        for hf in hybrids:
            self.graph.add_hybrid(hf)
            new_modes.append((hf.mode_var, hf.num_modes))

        mode_combos = [{}]
        for var, n in new_modes:
            mode_combos = [{**c, var: m} for c in mode_combos
                           for m in range(n)]

        assigns, warms = [], []
        for assignment, values, _ in self.hypotheses:
            warm = initial
            if values is not None:
                # keep prior estimates, adopt initial for new variables
                merged = {}
                for g in initial.groups():
                    if g not in values.groups():
                        merged[g] = initial[g]
                    elif values[g].shape == initial[g].shape:
                        merged[g] = values[g]
                    else:
                        n_old = values[g].shape[0]
                        merged[g] = torch.cat([values[g],
                                               initial[g][n_old:]])
                warm = Values(merged)
            for combo in mode_combos:
                assigns.append({**assignment, **combo})
                warms.append(warm)
        graphs = [self.graph.graph_at(a) for a in assigns]
        values_list, errs = _solve_batch(graphs, warms, self.params)
        cand = sorted(
            [(a, vals, self.graph._prior_energy(a, e))
             for a, vals, e in zip(assigns, values_list, errs)],
            key=lambda t: t[2])
        self.hypotheses = cand[:self.max_leaves]
        return self.hypotheses[0]

    def estimate(self):
        """(best values, best mode assignment, normalized posterior)."""
        a, v, _ = self.hypotheses[0]
        return v, a, _posterior(self.hypotheses, lambda h: h[2])


class HybridISAM:
    """Bounded-cost incremental hybrid inference: one ISAM2 engine per
    surviving discrete hypothesis (reference capability:
    HybridGaussianISAM / HybridNonlinearISAM driving Hybrid_City10000).

    Continuous factors stream into every surviving hypothesis's engine. A
    hybrid factor branches every hypothesis over the new mode variable's
    values on cloned engines (ISAM2.clone shares the device state, which
    updates replace and never write in place), updates each, reads its
    energy, and prunes back to `max_leaves`: per-update cost is
    O(max_leaves * modes) bounded engine updates."""

    def __init__(self, max_leaves: int = 4, params=None, *, device="cuda"):
        self.max_leaves = max_leaves
        self.params = params or ISAM2Params()
        # (assignment dict, engine, energy)
        self.hypotheses = [({}, ISAM2(self.params, device=device), 0.0)]

    def add_variable(self, group: str, value) -> int:
        i = None
        for _, e, _ in self.hypotheses:
            i = e.add_variable(group, value)
        return i

    def add_factor(self, name, residual_fn, groups, rdim, idx, meas, noise):
        for _, e, _ in self.hypotheses:
            e.add_factor(name, residual_fn, groups, rdim, idx, meas, noise)

    def update(self):
        for _, e, _ in self.hypotheses:
            e.update()

    def add_hybrid_factor(self, name, residual_fn, groups, rdim, idx,
                          meas_modes: Sequence[dict], noise, mode_var: int,
                          mode_prior: Optional[Sequence[float]] = None):
        """Branch every hypothesis over the new mode variable, update each
        branch's engine, score, prune. `meas_modes[m]` is the measurement
        dict for mode m; `noise` may be a single NoiseModel or one per mode;
        `mode_prior[m]` an optional prior probability."""
        M = len(meas_modes)
        noises = noise if isinstance(noise, (list, tuple)) else [noise] * M
        prior_e = (np.zeros(M) if mode_prior is None
                   else -np.log(np.clip(np.asarray(mode_prior, float),
                                        1e-300, None)))
        # raw least-squares energies are comparable across modes only when
        # the per-mode noises are identical; otherwise the -log|det W_m|
        # constant joins the hypothesis energy (reference:
        # HybridGaussianFactor logNormalizers)
        prior_e = prior_e - np.array([log_det_whitener(nm) for nm in noises])
        cand = []
        for a, e, _ in self.hypotheses:
            for m in range(M):
                e2 = e.clone() if m < M - 1 else e
                e2.add_factor(name, residual_fn, groups, rdim, idx,
                              meas_modes[m], noises[m])
                e2.update()
                cand.append(({**a, mode_var: m}, e2,
                             e2.error() + prior_e[m]))
        cand.sort(key=lambda t: t[2])
        self.hypotheses = cand[:self.max_leaves]
        return self.hypotheses[0]

    def estimate(self):
        """(best engine's Values, best assignment, normalized posterior)."""
        a, e, _ = self.hypotheses[0]
        return (e.calculate_estimate(), a,
                _posterior(self.hypotheses, lambda h: h[2]))

    def best_engine(self):
        return self.hypotheses[0][1]
