"""Multi-process runtime: torch.distributed init and the global mesh.

Counterpart of featurebase_tpu/parallel/multihost.py (reference:
etcd/embed.go:421 Start joins the raft cluster; disco/disco.go:35).  N
processes join one torch.distributed process group over TCP, and one
"shards" mesh spans their members, process by process, so that each
process's members hold a contiguous range of the stacked layout and a merge
is the local members' partials summed, then one all-reduce across
processes (parallel/agg.py ``_psum``).

The backend is the caller's choice, as ``cpu_collectives`` is in the JAX
package, never switched behind its back: "gloo" for CPU members and for
processes that share one card (NCCL refuses two ranks on one card), "nccl"
where each process has its own card.  Gloo's collectives here run on host
tensors: a merge on CUDA members moves its int64 partials to the host for
the all-reduce and back, an explicit step of the Gloo backend.
"""
from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch

from featurebase_tpu_torch.parallel.mesh import Mesh, Sharded, _canonical

BACKENDS = ("gloo", "nccl")
# a rendezvous or collective that waits longer fails instead of hanging
TIMEOUT = datetime.timedelta(seconds=120)


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: str) -> None:
    """Join the process group at tcp://coordinator_address (host:port) as
    rank process_id of num_processes, over `backend` ("gloo" or "nccl")."""
    import torch.distributed as dist
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def shutdown() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(members_per_process: int, device) -> Mesh:
    """1-D "shards" mesh of every process's members: this process
    contributes `members_per_process` members on `device` (repeats of one
    device), and the members are ordered process by process (JAX
    multihost.py:42-51: each host's devices contiguous)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("multihost.initialize first")
    device = _canonical(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    names: List[Optional[str]] = [None] * world
    dist.all_gather_object(names, str(device))
    members = [d for name in names for d in [name] * members_per_process]
    local = range(rank * members_per_process,
                  (rank + 1) * members_per_process)
    return Mesh(members, local, group=dist.group.WORLD,
                backend=dist.get_backend())


def put_sharded(host: np.ndarray, mesh: Mesh,
                shards: Optional[Sequence[int]] = None) -> Sharded:
    """A Sharded array from a host array that every process holds: each
    process uploads only its own blocks (JAX multihost.py:54-60)."""
    return mesh.put(host, shards)


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` where the backend's collectives take it: the host for
    Gloo, this process's card for NCCL."""
    dev = torch.device("cpu") if mesh.backend == "gloo" else \
        mesh.local_devices[0]
    return t.to(dev, copy=True).contiguous()


def all_reduce(mesh: Mesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """`t` reduced over the mesh's processes ("sum", "min" or "max"); `t`
    itself on a mesh of one process."""
    if mesh.group is None:
        return t
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    buf = _wire(mesh, t)
    dist.all_reduce(buf, op=red, group=mesh.group)
    return buf.to(t.device)


def all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every process's `t` (one shape on every process) concatenated along
    axis 0 in process order; `t` itself on a mesh of one process."""
    if mesh.group is None:
        return t
    import torch.distributed as dist
    src = _wire(mesh, t)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(t.device)


def all_gather_object(mesh: Mesh, obj) -> list:
    """Every process's picklable `obj`, in process order; [obj] on a mesh
    of one process."""
    if mesh.group is None:
        return [obj]
    import torch.distributed as dist
    out: list = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
