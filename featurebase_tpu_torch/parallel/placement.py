"""Owner-placed host masters for a mesh that spans processes.

Counterpart of the policy part of featurebase_tpu/parallel/placement.py
(reference: the computer's directive-driven shard load,
api_directive.go:559 loadShard, dax/directive.go:8):

- `configure(n, pid)` installs the policy (a process of a multi-process
  mesh does this after `multihost.initialize`).  Ownership uses the
  reference's placement math, FNV shard partition -> jump hash over
  processes with `replicas` consecutive owners (disco/snapshot.go:64-135),
  so adding shards never re-homes existing ones.
- Fields consult `owns()` at write time (model/field.py ``_writable``): a
  write for a shard this process does not own records the shard and row
  metadata only, so the schema and the shard set stay agreed across
  processes while host bytes scale with the owned share.
- `layout()` orders a shard list so that each process's owned shards form
  its contiguous member blocks of the stacked mesh arrays, padded with -1
  sentinel shards that every read path takes as empty; a process then
  builds only blocks of shards it stores (Mesh.put_lazy).

The handoff of host fragments when the process count changes (the JAX
module's drop_shards, handoff, previous_n and reconfigure) needs shard
snapshots, their restore and the cluster client, which belong to the
cluster (ROADMAP.md queue 1 item 14).
"""
from __future__ import annotations

from typing import List, Optional

from featurebase_tpu_torch.core.consts import PARTITION_N
from featurebase_tpu_torch.storage.translate import (jump_hash,
                                                     shard_to_shard_partition)


class _Policy:
    __slots__ = ("n_processes", "process_id", "replicas")

    def __init__(self, n_processes: int, process_id: int, replicas: int):
        self.n_processes = n_processes
        self.process_id = process_id
        self.replicas = max(1, min(replicas, n_processes))


_policy: Optional[_Policy] = None


def configure(n_processes: int, process_id: int, replicas: int = 1):
    global _policy
    _policy = _Policy(n_processes, process_id, replicas)


def clear():
    global _policy
    _policy = None


def active() -> bool:
    return _policy is not None


def owner(index_name: str, shard: int, n_processes: int = 0) -> int:
    """Primary owner process of a shard (reference placement math:
    FNV(index, shard) % 256 partitions -> jump hash over the node set,
    disco/snapshot.go:64,117)."""
    n = n_processes or _policy.n_processes
    part = shard_to_shard_partition(index_name, int(shard), PARTITION_N)
    return jump_hash(part, n)


def owners(index_name: str, shard: int) -> List[int]:
    p = _policy
    start = owner(index_name, shard)
    return [(start + i) % p.n_processes for i in range(p.replicas)]


def owns(index_name: str, shard: int) -> bool:
    return _policy.process_id in owners(index_name, shard)


def layout(index_name: str, shards: List[int], n_devices: int) -> List[int]:
    """Mesh row order for a shard list: each process's owned shards
    grouped contiguously at its member-block positions, padded with -1
    (the empty-shard sentinel) so that every process's segment has equal
    length and a whole number of rows per member."""
    p = _policy
    dpp = max(1, n_devices // p.n_processes)
    groups: List[List[int]] = [[] for _ in range(p.n_processes)]
    for s in sorted(set(int(x) for x in shards)):
        groups[owner(index_name, s)].append(s)
    seg = max(1, max(len(g) for g in groups))
    seg += (-seg) % dpp  # whole member rows per process
    out: List[int] = []
    for g in groups:
        out.extend(g)
        out.extend([-1] * (seg - len(g)))
    return out
