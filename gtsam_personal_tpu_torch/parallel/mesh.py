"""Process groups, and factor graphs dealt over the ranks of one.

JAX counterpart: gtsam_personal_tpu/parallel/mesh.py (make_mesh,
_per_factor_noise, shard_graph, replicate_values). The JAX package runs
one SPMD program over a `jax.sharding.Mesh` of devices, and XLA places the
collectives; here each rank is one process (or, in the tests, one thread)
running its own program, and every `psum` of the JAX code is an explicit
all-reduce on the rank's process group.

A `Mesh` is that group made explicit: the `torch.distributed` process
group, this rank, the world size and the device of the rank's tensors. It
is passed to every distributed function; nothing reads a global group.
The one collective is `all_reduce` (sum): gloo, the one backend that can
put several ranks on one card, takes CUDA tensors for it and `broadcast`
only (it stages them through host memory).

`shard_graph` deals every factor batch over the ranks; `sharded_step` is
the explicit form of the JAX package's sharded LM step
(tests/test_parallel.py:27-45 there, GSPMD through `solvers.solve_pcg`):
the rank linearizes its share, PCG sums each normal-equation product over
the ranks (linear/solvers.py:solve_pcg's `group`), and the error is summed
the same way.
"""

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from gtsam_personal_tpu_torch import config
from gtsam_personal_tpu_torch.core.graph import FactorBatch, FactorGraph
from gtsam_personal_tpu_torch.core.values import Values
from gtsam_personal_tpu_torch.linear import solvers
from gtsam_personal_tpu_torch.linear.linearize import linearize
from gtsam_personal_tpu_torch.linear.noise import NoiseModel


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a process group.

    group: a `torch.distributed` ProcessGroup (None for a world of one);
    rank, size: this rank and the world size; device: where this rank's
    tensors live. skip: every collective is the identity (the second run of
    the `collective_overhead` measures: the same work, no communication,
    wrong results)."""
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    skip: bool = False

    def without_collectives(self) -> "Mesh":
        return dataclasses.replace(self, skip=True)

    def psum(self, t):
        """Sum of `t` over the ranks, in place (t must be contiguous);
        returns t."""
        if not t.is_contiguous():
            raise ValueError("psum: the tensor must be contiguous")
        if self.size > 1 and not self.skip:
            self.group.allreduce([t]).wait()
        return t

    def sums(self, xs):
        """A list of 0-d tensors, each summed over the ranks, in one
        all-reduce."""
        return list(self.psum(torch.stack(xs)).unbind())

    def psum_tree(self, tree):
        """A dict of tensors summed over the ranks, in one all-reduce."""
        keys = sorted(tree)
        flat = self.psum(torch.cat([tree[k].reshape(-1) for k in keys]))
        parts = flat.split([tree[k].numel() for k in keys])
        return {k: p.view(tree[k].shape) for k, p in zip(keys, parts)}

    def barrier(self):
        """Returns once every rank has reached it (an all-reduce of one
        element)."""
        self.psum(torch.zeros(1, device=self.device))


def make_mesh(group=None, device=None) -> Mesh:
    """The Mesh of `group` (default: the initialized default group, else a
    world of one). The device defaults to this rank's card, `cuda:rank %
    card count` (cuda:0 for every rank of a group on one card); pass
    device="cpu" to run on the CPU."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    rank = group.rank() if group is not None else 0
    size = group.size() if group is not None else 1
    if device is None:
        cards = torch.cuda.device_count()
        device = f"cuda:{rank % cards}" if cards else "cuda"
    return Mesh(group, rank, size, config.device(device))


def _per_factor_noise(noise: NoiseModel, K: int, rdim: int,
                      like: torch.Tensor) -> NoiseModel:
    """Noise data with a leading K axis, so that padded rows can be given
    zero information."""
    if noise.kind == "unit":
        return NoiseModel("diag", like.new_ones((K, rdim)), noise.robust,
                          noise.k)
    data = noise.data
    if data.dim() == (2 if noise.kind == "full" else 1):
        data = data.expand((K,) + data.shape)
    elif data.shape[0] != K:
        data = data[0].expand((K,) + data.shape[1:])
    return NoiseModel(noise.kind, data, noise.robust, noise.k)


def shard_graph(graph: FactorGraph, mesh: Mesh) -> FactorGraph:
    """This rank's share of every factor batch, on the mesh's device.

    A batch of K factors is padded to a multiple of the world size with
    copies of factor 0 that carry zero information (sqrt-information 0; an
    infinite sigma in a constrained model), then dealt in contiguous
    blocks: rank r takes rows [r K', (r + 1) K') of the padded batch. The
    padded rows add nothing to any sum."""
    n, r = mesh.size, mesh.rank
    out = []
    for b in graph.batches:
        K = b.size
        pad = (-K) % n
        Kl = (K + pad) // n
        like = next(iter(b.meas.values())) if b.meas else b.idx.double()
        noise = _per_factor_noise(b.noise, K, b.rdim, like)

        def padk(x):
            if pad:
                x = torch.cat([x, x[:1].expand((pad,) + x.shape[1:])])
            return x[r * Kl:(r + 1) * Kl].to(mesh.device)

        data = noise.data
        if pad:
            dead = float("inf") if noise.kind == "constrained" else 0.0
            data = torch.cat([data, torch.full((pad,) + data.shape[1:], dead,
                                               dtype=data.dtype,
                                               device=data.device)])
        data = data[r * Kl:(r + 1) * Kl].to(mesh.device)
        k = noise.k
        if k is not None and k.dim() >= 1 and k.shape[0] == K:
            k = padk(k)
        elif k is not None:
            k = k.to(mesh.device)
        out.append(FactorBatch(b.name, b.residual_fn, b.groups, b.rdim,
                               padk(b.idx),
                               {name: padk(v) for name, v in b.meas.items()},
                               NoiseModel(noise.kind, data, noise.robust, k),
                               b.sign))
    return FactorGraph(out)


def replicate_values(values: Values, mesh: Mesh) -> Values:
    """The values on the mesh's device: every rank holds all of them."""
    return Values({g: v.to(mesh.device) for g, v in values.blocks.items()})


def sharded_error(graph: FactorGraph, values: Values, mesh: Mesh):
    """The error of a graph dealt by shard_graph, summed over the ranks (a
    0-d tensor, the same on every rank)."""
    return mesh.psum(graph.error(values).reshape(1))[0]


def sharded_step(graph: FactorGraph, values: Values, lam, mesh: Mesh,
                 maxiter=100, tol=1e-10):
    """One damped Gauss-Newton step of a graph dealt by shard_graph:
    linearize this rank's factors, solve by PCG with the normal-equation
    products summed over the ranks, retract, and the new error summed over
    the ranks. Returns (new values, error); both the same on every rank."""
    lin = linearize(graph, values)
    delta = solvers.solve_pcg(lin, lam, maxiter=maxiter, tol=tol, group=mesh)
    new = values.retract(delta)
    return new, sharded_error(graph, new, mesh)
