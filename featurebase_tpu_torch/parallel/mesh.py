"""Device mesh, the sharded layout and shard placement (PyTorch/CUDA).

Counterpart of featurebase_tpu/parallel/mesh.py (reference: cluster.go:29,
disco/snapshot.go:24-135 ShardToShardPartition + jump-hash PartitionNodes).
A ``Mesh`` is one "shards" axis: an ordered list of member devices, in
which a device may repeat (four members on one card run the layout, the
padding, the per-member launches and the merges without a second card),
the positions of the members this process holds, and, when the members
span processes, the torch.distributed process group that joins them
(parallel/multihost.py).

The sharded layout is the JAX package's ``NamedSharding(mesh, P("shards",
...))``: a stacked (S, ...) array is padded to S_pad = S + (-S) % n rows
and split into n contiguous equal blocks in shard-list order, block i on
member i's device.  Padding rows are zero, and so is a -1 sentinel shard
of an owner-placed layout (parallel/placement.py).  ``Sharded`` holds this
process's blocks of such an array: it stands in for a jax.Array sharded
over the mesh, and parallel/agg.py launches a kernel on each block and
merges the partials.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from featurebase_tpu_torch.storage.translate import (jump_hash,
                                                     shard_to_shard_partition)


def _canonical(device) -> torch.device:
    """`device` with its index ("cuda" is the current card)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; name CPU members "
                               "(devices=['cpu'] * n) to build a CPU mesh")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported mesh member {device}")
    return device


class Mesh:
    """A 1-D "shards" mesh (see the module docstring).  `members` is every
    member's device in mesh order, `local` the positions of this process's
    members (all of them in one process), `group` the process group of a
    mesh that spans processes and `backend` its torch.distributed backend."""

    def __init__(self, members: Sequence, local: Optional[Sequence[int]] = None,
                 group=None, backend: Optional[str] = None):
        self.members: List[torch.device] = [torch.device(d) for d in members]
        if not self.members:
            raise ValueError("a mesh needs at least one member")
        self.local: List[int] = list(range(len(self.members))) \
            if local is None else [int(i) for i in local]
        self.group = group
        self.backend = backend

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def local_devices(self) -> List[torch.device]:
        return [self.members[i] for i in self.local]

    @property
    def spans_processes(self) -> bool:
        return len(self.local) != self.size

    def padded(self, S: int) -> int:
        """S_pad = S + (-S) % n: the rows of a stacked array on the mesh."""
        return S + (-S) % self.size

    def layout(self, shards: Sequence[int]) -> List[int]:
        """The shard list padded with -1 to a whole block per member."""
        shards = [int(s) for s in shards]
        return shards + [-1] * (self.padded(len(shards)) - len(shards))

    def put_lazy(self, shape, fill: Callable[[int, np.ndarray], None],
                 shards: Sequence[int]) -> "Sharded":
        """Build this process's blocks of a stacked (len(shards), ...)
        uint32 array, padded to S_pad, one block at a time in a host buffer
        (pinned for a card), and upload each to its member's device.
        `fill(p, out)` writes the row at position p of `shards` into `out`;
        it is never asked for a padding row or a -1 sentinel shard, so a
        process reads host masters only for the shards its blocks hold."""
        lay = self.layout(shards)
        B = len(lay) // self.size
        tail = tuple(int(x) for x in shape[1:])
        blocks = []
        for m in self.local:
            dev = self.members[m]
            buf = torch.zeros((B,) + tail, dtype=torch.int32,
                              pin_memory=dev.type == "cuda")
            host = buf.numpy().view(np.uint32)
            for i in range(B):
                p = m * B + i
                if p < len(shards) and lay[p] >= 0:
                    fill(p, host[i])
            blocks.append(buf.to(dev, non_blocking=True))
        return Sharded(self, lay, blocks)

    def put(self, host: np.ndarray, shards: Optional[Sequence[int]] = None
            ) -> "Sharded":
        """A stacked host array (S, ...) as a Sharded array over the mesh
        (this process's blocks only; `shards` names its rows, by default
        0..S-1)."""
        host = np.asarray(host)
        if shards is None:
            shards = list(range(host.shape[0]))
        if len(shards) != host.shape[0]:
            raise ValueError(f"{len(shards)} shards for {host.shape[0]} rows")
        arr = host.view(np.uint32) if host.dtype.itemsize == 4 else \
            host.astype(np.uint32)

        def fill(p, out):
            out[...] = arr[p]
        return self.put_lazy(arr.shape, fill, shards)

    def __repr__(self) -> str:
        procs = f", processes via {self.backend}" if self.group is not None \
            else ""
        return (f"Mesh(shards={self.size}: "
                f"{', '.join(map(str, self.members))}{procs})")


class Sharded:
    """This process's blocks of a stacked array laid out over a mesh:
    `shards` is the layout (S_pad entries, -1 for padding and sentinels),
    `blocks` the local members' blocks in `mesh.local` order (the member
    positions), each (S_pad / n, ...) on its member's device."""

    __slots__ = ("mesh", "shards", "blocks")

    def __init__(self, mesh: Mesh, shards: Sequence[int],
                 blocks: Sequence[torch.Tensor]):
        self.mesh = mesh
        self.shards = list(shards)
        self.blocks = list(blocks)
        if len(self.shards) % mesh.size or \
                len(self.blocks) != len(mesh.local):
            raise ValueError("a Sharded array needs a whole block per member "
                             "and one block per local member")

    @property
    def S(self) -> int:
        """The real shards laid out (padding and sentinels not counted)."""
        return sum(1 for s in self.shards if s >= 0)

    @property
    def S_pad(self) -> int:
        return len(self.shards)

    @property
    def block_rows(self) -> int:
        return self.S_pad // self.mesh.size

    def shards_of(self, k: int) -> List[int]:
        """The layout entries of local block k."""
        m, B = self.mesh.local[k], self.block_rows
        return self.shards[m * B:(m + 1) * B]

    def map(self, fn: Callable, *others: "Sharded") -> "Sharded":
        """A shard-local op on each block (with the same block of each of
        `others`), as a Sharded array of the same layout."""
        return Sharded(self.mesh, self.shards, [
            fn(b, *(o.blocks[k] for o in others))
            for k, b in enumerate(self.blocks)])

    def require_whole(self, what: str) -> None:
        """Raise when this process does not hold every block (the JAX
        package's fetch of an array over non-addressable devices fails
        the same way)."""
        if self.mesh.spans_processes:
            raise RuntimeError(
                f"{what} needs every member's block, and this process holds "
                f"{len(self.mesh.local)} of the mesh's {self.mesh.size} (it "
                f"spans processes)")

    def rows(self, device: torch.device) -> Dict[int, torch.Tensor]:
        """{shard: its row} of every real shard, moved to `device`."""
        self.require_whole("a per-shard result")
        out = {}
        for k, b in enumerate(self.blocks):
            for i, s in enumerate(self.shards_of(k)):
                if s >= 0:
                    out[s] = b[i].to(device)
        return out

    def numpy(self) -> np.ndarray:
        """The whole (S_pad, ...) array on the host, as uint32 for 32-bit
        words (int64 stays int64)."""
        self.require_whole("the whole array")
        arr = torch.cat([b.cpu() for b in self.blocks]).numpy()
        return arr.view(np.uint32) if arr.dtype == np.int32 else arr


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 1-D "shards" mesh over every CUDA device, or over the first
    n_devices of them, or over the given devices (repeats allowed, CPU
    members for a CPU run).  Without CUDA and without devices it raises,
    as the executor's device rule does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices= (for "
                               "example ['cpu'] * 8) to build a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_canonical(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} members asked for, "
                             f"{len(devices)} devices given")
        devices = devices[:n_devices]
    return Mesh(devices)


def shard_device(index: str, shard: int, n_devices: int,
                 partition_n: int = 256) -> int:
    """Deterministic shard -> device assignment (reference semantics:
    shard -> partition via FNV-1a, partition -> node via jump hash;
    disco/snapshot.go:96 PrimaryNodeIndex)."""
    part = shard_to_shard_partition(index, shard, partition_n)
    return jump_hash(part, n_devices)


def shards_by_device(index: str, shards: List[int], n_devices: int):
    """Group shards by owning device (reference executor.go:6416
    shardsByNode)."""
    out: dict = {}
    for s in shards:
        out.setdefault(shard_device(index, s, n_devices), []).append(s)
    return out
