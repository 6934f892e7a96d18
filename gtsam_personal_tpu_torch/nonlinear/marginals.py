"""Posterior marginal covariances.

JAX counterpart: gtsam_personal_tpu/nonlinear/marginals.py (all of it;
reference: nonlinear/Marginals.h:32, marginalCovariance and
jointMarginalCovariance): assemble H = J^T J at the solution densely,
invert it once and slice the blocks.
"""

from typing import Sequence, Tuple

import torch

from gtsam_personal_tpu_torch.core.graph import FactorGraph
from gtsam_personal_tpu_torch.core.values import Layout, Values
from gtsam_personal_tpu_torch.linear.linearize import linearize


class Marginals:
    def __init__(self, graph: FactorGraph, values: Values,
                 damping: float = 0.0):
        self.layout = Layout.of(values)
        H, _ = linearize(graph, values).assemble_dense(self.layout)
        D = self.layout.total_dim
        self.cov = torch.linalg.inv(
            H + damping * torch.eye(D, dtype=H.dtype, device=H.device))

    def marginal_covariance(self, group: str, i: int):
        """Covariance of one variable in its tangent space."""
        off = self.layout.var_offset(group, i)
        d = self.layout.dims[group]
        return self.cov[off:off + d, off:off + d]

    def joint_marginal_covariance(self, vars: Sequence[Tuple[str, int]]):
        idx = []
        for g, i in vars:
            off = self.layout.var_offset(g, i)
            idx.extend(range(off, off + self.layout.dims[g]))
        idx = torch.tensor(idx, device=self.cov.device)
        return self.cov[idx[:, None], idx[None, :]]

    def marginal_information(self, group: str, i: int):
        return torch.linalg.inv(self.marginal_covariance(group, i))


def all_marginal_covariances(graph: FactorGraph, values: Values,
                             group: str, damping: float = 0.0):
    """Per-variable covariance blocks of a whole group, [N, d, d]."""
    m = Marginals(graph, values, damping)
    n = values.counts()[group]
    d = m.layout.dims[group]
    ar = torch.arange(d, device=m.cov.device)
    rows = (m.layout.offsets[group]
            + torch.arange(n, device=m.cov.device) * d)[:, None] + ar
    return m.cov[rows[:, :, None], rows[:, None, :]]
