"""Multi-process bootstrap for the distributed solvers.

JAX counterpart: gtsam_personal_tpu/parallel/bootstrap.py
(maybe_init_distributed, process_info). There, processes join one JAX
runtime with `jax.distributed.initialize`; here they join one
`torch.distributed` process group with `init_process_group`, and
`mesh.make_mesh()` then returns the group's Mesh.

    from gtsam_personal_tpu_torch.parallel import bootstrap, mesh
    bootstrap.maybe_init_distributed()      # no-op unless configured
    m = mesh.make_mesh()

Configuration, the JAX package's environment variables:
    GTSAM_TPU_DIST=1            enable (otherwise always a no-op)
    GTSAM_TPU_COORD=host:port   rank 0's address (init_method tcp://host:port)
    GTSAM_TPU_NPROCS=N          number of processes
    GTSAM_TPU_PROC_ID=k         this process's rank

The backend is NCCL when every rank can have a card of its own
(torch.cuda.device_count() >= N), else gloo, which can put several ranks on
one card and stages their CUDA tensors through host memory; NCCL refuses
two ranks on one GPU. A caller may name the backend.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist


def maybe_init_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group if distributed mode is configured.

    Explicit arguments override the GTSAM_TPU_* environment variables.
    Returns True if `init_process_group` was called, False for the
    single-process no-op. Raises ValueError if enabled but
    under-configured: torch, unlike a TPU pod, cannot infer the number of
    processes or the rank."""
    enabled = (coordinator is not None
               or os.environ.get("GTSAM_TPU_DIST") == "1")
    if not enabled:
        return False
    coordinator = coordinator or os.environ.get("GTSAM_TPU_COORD")
    if num_processes is None and "GTSAM_TPU_NPROCS" in os.environ:
        num_processes = int(os.environ["GTSAM_TPU_NPROCS"])
    if process_id is None and "GTSAM_TPU_PROC_ID" in os.environ:
        process_id = int(os.environ["GTSAM_TPU_PROC_ID"])
    if coordinator is None:
        raise ValueError(
            "distributed mode enabled (GTSAM_TPU_DIST=1) but no coordinator "
            "address: set GTSAM_TPU_COORD=host:port (process 0's address)")
    if num_processes is None or process_id is None:
        raise ValueError(
            "distributed mode needs the number of processes and this "
            "process's rank: set GTSAM_TPU_NPROCS and GTSAM_TPU_PROC_ID")
    if backend is None:
        backend = ("nccl" if dist.is_nccl_available()
                   and torch.cuda.device_count() >= num_processes
                   else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def process_info():
    """(rank, world size, local card count, world size) — after
    maybe_init_distributed; also valid in single-process mode. The JAX
    package's last entry is the global device count: here one rank is one
    process, whatever the cards."""
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = 0, 1
    return rank, size, torch.cuda.device_count(), size
