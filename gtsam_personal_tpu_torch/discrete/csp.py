"""Constraint-satisfaction solving on the dense discrete engine.

Mirrors `gtsam_unstable/discrete`: `CSP.h` (constraint graph with
optimalAssignment + arc consistency), constraint types `Domain`/`SingleValue`
(BinaryAllDiff/AllDiff, Constraint.h), and `Scheduler.h` (faculty/slot
assignment built as a CSP).

JAX counterpart: gtsam_personal_tpu/discrete/csp.py (all of it). Host
numpy (AC-3, the scheduler's bookkeeping) over discrete/discrete.py.

Design: constraints are 0/1 indicator tables on the dense
`DiscreteFactorGraph` (discrete/discrete.py) on `device` (the card unless
the caller names another), no decision diagrams. AllDiff decomposes into pairwise BinaryAllDiff (identical
solution set). Arc consistency (AC-3 over the binary constraint tables) runs
host-side as domain pruning, exactly the role of the reference's
`runArcConsistency` (gtsam_unstable/discrete/CSP.cpp).
"""

from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gtsam_personal_tpu_torch.discrete.discrete import DiscreteFactorGraph


def domain_table(card: int, allowed: Sequence[int]) -> np.ndarray:
    t = np.zeros(card)
    t[list(allowed)] = 1.0
    return t


def single_value_table(card: int, value: int) -> np.ndarray:
    return domain_table(card, [value])


def binary_all_diff_table(card: int) -> np.ndarray:
    return 1.0 - np.eye(card)


class CSP:
    """Constraint-satisfaction problem (reference: gtsam_unstable/discrete/
    CSP.h). Variables are integer ids with per-variable cardinalities."""

    def __init__(self, device="cuda"):
        self.graph = DiscreteFactorGraph(device)
        self.cards: Dict[int, int] = {}
        self._binary: List[Tuple[int, int, np.ndarray]] = []
        self._unary: Dict[int, np.ndarray] = {}

    def add_variable(self, v: int, card: int):
        self.cards[v] = card

    def add_domain(self, v: int, allowed: Sequence[int]):
        t = domain_table(self.cards[v], allowed)
        self._unary[v] = self._unary.get(v, np.ones(self.cards[v])) * t
        self.graph.add([v], t)

    def add_single_value(self, v: int, value: int):
        self.add_domain(v, [value])

    def add_binary_all_diff(self, v1: int, v2: int):
        if self.cards[v1] != self.cards[v2]:
            raise ValueError(
                f"add_binary_all_diff requires equal cardinalities "
                f"({v1}: {self.cards[v1]} vs {v2}: {self.cards[v2]})")
        t = binary_all_diff_table(self.cards[v1])
        self._binary.append((v1, v2, t))
        self.graph.add([v1, v2], t)

    def add_all_diff(self, vars: Sequence[int]):
        """AllDiff via pairwise decomposition (same solution set as the
        reference's AllDiff constraint)."""
        vs = list(vars)
        for i in range(len(vs)):
            for j in range(i + 1, len(vs)):
                self.add_binary_all_diff(vs[i], vs[j])

    def add_constraint_table(self, vars: Sequence[int], table):
        t = np.asarray(table, dtype=float)
        if len(vars) == 1:
            v = vars[0]
            self._unary[v] = self._unary.get(v, np.ones(self.cards[v])) * t
        elif len(vars) == 2:
            self._binary.append((vars[0], vars[1], t))
        self.graph.add(list(vars), t)

    # -- solving -------------------------------------------------------------
    def optimal_assignment(self,
                           ordering: Optional[Sequence[int]] = None
                           ) -> Dict[int, int]:
        """Max-product elimination + back-substitution (reference:
        CSP::optimalAssignment)."""
        return self.graph.optimize(ordering)

    def is_satisfied(self, assignment: Dict[int, int]) -> bool:
        return float(self.graph.evaluate(assignment)) > 0.0

    def run_arc_consistency(self) -> Dict[int, np.ndarray]:
        """AC-3 domain pruning over the binary constraints; returns the
        reduced 0/1 domain mask per variable (reference:
        CSP::runArcConsistency). Raises if a domain empties (infeasible).

        AC-3 terminates on its own (each requeue strictly shrinks a domain),
        so there is no sweep cap; the worklist is a deque for O(1) pops."""
        dom = {v: self._unary.get(v, np.ones(c)).copy().astype(bool)
               for v, c in self.cards.items()}
        arcs = []
        for v1, v2, t in self._binary:
            arcs.append((v1, v2, t))
            arcs.append((v2, v1, t.T))
        queue = deque(arcs)
        while queue:
            v1, v2, t = queue.popleft()
            # value a of v1 is supported if exists b in dom[v2] with t[a,b]>0
            support = (t[:, dom[v2]] > 0).any(axis=1)
            new = dom[v1] & support
            if not new.any():
                raise ValueError(f"arc consistency: variable {v1} has empty domain")
            if (new != dom[v1]).any():
                dom[v1] = new
                queue.extend(a for a in arcs if a[1] == v1)
        return {v: d.astype(float) for v, d in dom.items()}


class Scheduler(CSP):
    """Faculty-meeting scheduler (reference: gtsam_unstable/discrete/
    Scheduler.h): each student needs one time slot and one faculty member per
    required area; a faculty member can attend at most one meeting per slot.

    Variables: per student s, a slot variable (card = num_slots) and one
    faculty variable per area (card = num_faculty). Constraints: faculty must
    cover the student's area (domain), all student slots distinct (AllDiff —
    single-committee-room model), and advisor exclusions."""

    def __init__(self, num_slots: int, faculty: Sequence[str],
                 device="cuda"):
        super().__init__(device)
        self.num_slots = num_slots
        self.faculty = list(faculty)
        self.students: List[str] = []
        self.slot_var: Dict[str, int] = {}
        self.prof_var: Dict[Tuple[str, str], int] = {}
        self._next = 0

    def _new_var(self, card: int) -> int:
        v = self._next
        self._next += 1
        self.add_variable(v, card)
        return v

    def add_student(self, name: str, areas: Dict[str, Sequence[str]],
                    available_slots: Optional[Sequence[int]] = None,
                    advisor: Optional[str] = None):
        """areas: area name -> faculty qualified in that area."""
        self.students.append(name)
        sv = self._new_var(self.num_slots)
        self.slot_var[name] = sv
        if available_slots is not None:
            self.add_domain(sv, available_slots)
        fvars = []
        for area, qualified in areas.items():
            fv = self._new_var(len(self.faculty))
            self.prof_var[(name, area)] = fv
            allowed = [self.faculty.index(f) for f in qualified
                       if advisor is None or f != advisor]
            self.add_domain(fv, allowed)
            fvars.append(fv)
        # committee members distinct for this student
        if len(fvars) > 1:
            self.add_all_diff(fvars)

    def finalize(self):
        """All students meet in different slots (single-room model)."""
        if len(self.students) > 1:
            self.add_all_diff([self.slot_var[s] for s in self.students])

    def schedule(self) -> Dict[str, dict]:
        self.finalize()
        sol = self.optimal_assignment()
        if not self.is_satisfied(sol):
            raise ValueError("no feasible schedule")
        out = {}
        for s in self.students:
            committee = {area: self.faculty[sol[fv]]
                         for (st, area), fv in self.prof_var.items() if st == s}
            out[s] = {"slot": sol[self.slot_var[s]], "committee": committee}
        return out
