"""Values: one stacked tensor of manifold points per variable group.

JAX counterpart: gtsam_personal_tpu/core/values.py (all of it; reference:
gtsam/nonlinear/Values.h:65 and linear/VectorValues.h). `{"se2": f[N, 3],
"point3": f[M, 3], ...}`; a key is the pair (group, index). The tangent
space is the matching dict of [N, dim] tensors, which every solver works on
directly. `Values` is a plain class over a dict: torch needs no pytree
registration.
"""

from typing import Dict

import numpy as np
import torch

from gtsam_personal_tpu_torch.core import manifolds


class Values:
    """Dict of per-group stacked manifold points; never modified in place."""

    def __init__(self, blocks: Dict[str, torch.Tensor]):
        self.blocks = dict(blocks)

    def __getitem__(self, group):
        return self.blocks[group]

    def at(self, group, i):
        return self.blocks[group][i]

    def groups(self):
        return sorted(self.blocks)

    def counts(self):
        return {g: int(self.blocks[g].shape[0]) for g in self.blocks}

    def with_block(self, group, arr):
        b = dict(self.blocks)
        b[group] = arr
        return Values(b)

    def retract(self, tangent: Dict[str, torch.Tensor]) -> "Values":
        """Per-variable manifold retract (reference: Values::retract,
        Values.h:223); a group without a tangent stays as it is."""
        out = {}
        for g, x in self.blocks.items():
            d = tangent.get(g)
            out[g] = x if d is None else manifolds.batched_retract(
                manifolds.get(g), x, d)
        return Values(out)

    def retract_masked(self, tangent: Dict[str, torch.Tensor],
                       mask: Dict[str, torch.Tensor]) -> "Values":
        """Retract only where mask is True (reference: Values::retractMasked,
        Values.h:229, used by ISAM2's partial relinearization)."""
        masked = {}
        for g, d in tangent.items():
            m = mask.get(g)
            masked[g] = d if m is None else d * m[:, None].to(d.dtype)
        return self.retract(masked)

    def local(self, other: "Values") -> Dict[str, torch.Tensor]:
        """Tangent from self to other, per variable."""
        return {g: manifolds.batched_local(manifolds.get(g), x,
                                           other.blocks[g])
                for g, x in self.blocks.items()}

    def zero_tangent(self) -> Dict[str, torch.Tensor]:
        return {g: x.new_zeros((x.shape[0], manifolds.get(g).dim))
                for g, x in self.blocks.items()}

    def tangent_dim(self) -> int:
        return sum(x.shape[0] * manifolds.get(g).dim
                   for g, x in self.blocks.items())

    def __repr__(self):
        return "Values(%s)" % ", ".join(
            "%s[%d]" % (g, self.blocks[g].shape[0]) for g in self.groups())


def values_from_numpy(blocks, *, device, dtype) -> Values:
    """Values on `device` from {group: array [N, *param_shape]} of any array
    source (numpy, or `np.asarray` of another package's blocks)."""
    return Values({g: torch.tensor(np.asarray(a), dtype=dtype, device=device)
                   for g, a in blocks.items()})


# -- tangent-space (VectorValues) helpers on dicts of tensors ----------------

def tree_vdot(a, b):
    return sum((a[g] * b[g]).sum() for g in sorted(a))


def tree_add(a, b):
    return {g: a[g] + b[g] for g in a}


def tree_sub(a, b):
    return {g: a[g] - b[g] for g in a}


def tree_scale(a, s):
    return {g: x * s for g, x in a.items()}


def tree_axpy(alpha, x, y):
    return {g: alpha * x[g] + y[g] for g in x}


def tree_zeros_like(a):
    return {g: torch.zeros_like(x) for g, x in a.items()}


def tree_norm(a):
    return torch.sqrt(tree_vdot(a, a))


class Layout:
    """Static map of (group, index) -> slice of the flat tangent vector, for
    the dense solvers (reference: linear/Scatter.h). `counts` names at least
    one group."""

    def __init__(self, counts: Dict[str, int]):
        self.groups = sorted(counts)
        self.counts = dict(counts)
        self.dims = {g: manifolds.get(g).dim for g in self.groups}
        self.offsets = {}
        off = 0
        for g in self.groups:
            self.offsets[g] = off
            off += self.counts[g] * self.dims[g]
        self.total_dim = off

    @classmethod
    def of(cls, values: Values) -> "Layout":
        return cls(values.counts())

    def flatten(self, tangent: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([tangent[g].reshape(-1) for g in self.groups])

    def unflatten(self, vec: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for g in self.groups:
            n, d = self.counts[g], self.dims[g]
            off = self.offsets[g]
            out[g] = vec[off:off + n * d].reshape(n, d)
        return out

    def var_offset(self, group: str, i: int) -> int:
        return self.offsets[group] + i * self.dims[group]
