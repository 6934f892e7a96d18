"""Failure diagnosis for linear systems: name the offending variable or
factor.

JAX counterpart: gtsam_personal_tpu/linear/diagnostics.py (all of it;
reference: IndeterminantLinearSystemException, linear/linearExceptions.h,
which carries the key of the variable whose elimination hit a zero or
indefinite pivot). The batched Cholesky of this package never pivots (a
failed front gives NaN, solvers.cholesky_nan), so the diagnosis is made
afterwards: (a) non-finite residual or Jacobian rows, naming the factor
batch and row, and (b) per-variable block-diagonal Hessian blocks whose
least eigenvalue is near zero or negative (under-constrained variables:
gauge freedom, a missing prior, a variable no factor touches).

The per-row checks and the block eigenvalues (`torch.linalg.eigvalsh`) run
on the device of the linearization; the report is read on the host.

    from gtsam_personal_tpu_torch.linear import diagnostics
    report = diagnostics.diagnose(graph, values)
    print(report)                    # or report.raise_if_bad()
"""

from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from gtsam_personal_tpu_torch.linear.linearize import linearize


@dataclass
class Report:
    """Human-readable diagnosis; empty lists mean the system looks
    solvable."""
    nonfinite_factors: List[Tuple[str, int]] = field(default_factory=list)
    singular_variables: List[Tuple[str, int, float]] = field(
        default_factory=list)
    min_block_eig: float = float("inf")

    @property
    def ok(self) -> bool:
        return not self.nonfinite_factors and not self.singular_variables

    def __str__(self):
        if self.ok:
            return ("linear system OK: all residuals/Jacobians finite, "
                    f"min per-variable block eigenvalue "
                    f"{self.min_block_eig:.3e}")
        lines = ["linear system diagnosis:"]
        for name, row in self.nonfinite_factors[:20]:
            lines.append(f"  NON-FINITE residual/Jacobian in factor batch "
                         f"'{name}' row {row}")
        for g, i, ev in self.singular_variables[:20]:
            lines.append(f"  SINGULAR/INDEFINITE block for variable "
                         f"{g}[{i}]: min eigenvalue {ev:.3e} "
                         f"(under-constrained? missing prior/gauge fix?)")
        extra = (len(self.nonfinite_factors) + len(self.singular_variables)
                 - min(20, len(self.nonfinite_factors))
                 - min(20, len(self.singular_variables)))
        if extra > 0:
            lines.append(f"  ... and {extra} more")
        return "\n".join(lines)

    def raise_if_bad(self):
        """The analogue of throwing IndeterminantLinearSystemException
        (reference: linear/linearExceptions.h:35)."""
        if not self.ok:
            raise IndeterminantLinearSystemError(str(self), self)


class IndeterminantLinearSystemError(RuntimeError):
    def __init__(self, msg, report: Report):
        super().__init__(msg)
        self.report = report


def diagnose_linear(lin, eig_tol: float = 1e-10) -> Report:
    """Diagnose a linearized system (a GaussianGraph of
    linear/linearize.py): every factor batch's non-finite rows and every
    variable's Hessian block with a least eigenvalue below `eig_tol`."""
    rep = Report()
    for b in lin.batches:
        bad = ~torch.isfinite(b.r.reshape(b.r.shape[0], -1).sum(1))
        for J in b.Js:
            bad = bad | ~torch.isfinite(J.reshape(J.shape[0], -1).sum(1))
        rows = torch.nonzero(bad).flatten()[:50].tolist()
        name = getattr(b, "name", None) or "+".join(b.groups)
        rep.nonfinite_factors.extend((name, int(row)) for row in rows)

    for g, B in lin.hessian_block_diagonal().items():
        finite = torch.isfinite(B.reshape(B.shape[0], -1))
        if not bool(finite.all()):
            badv = torch.nonzero(~finite.all(1)).flatten()[:50].tolist()
            rep.singular_variables.extend((g, int(i), float("nan"))
                                          for i in badv)
            continue
        mins = torch.linalg.eigvalsh(0.5 * (B + B.transpose(1, 2)))[:, 0]
        mins = mins.cpu()
        rep.min_block_eig = min(rep.min_block_eig, float(mins.min()))
        for i in torch.nonzero(mins < eig_tol).flatten()[:50].tolist():
            rep.singular_variables.append((g, int(i), float(mins[i])))
    return rep


def diagnose(graph, values, eig_tol: float = 1e-10) -> Report:
    """Linearize `graph` at `values` and diagnose."""
    return diagnose_linear(linearize(graph, values), eig_tol=eig_tol)
