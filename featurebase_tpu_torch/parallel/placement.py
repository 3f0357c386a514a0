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

- `handoff()` moves host fragments when the process count changes: the
  shards whose ownership arrives load from a peer's shard snapshot (the
  backup and resync byte format, API.shard_snapshot_bytes) and the
  departures are dropped with their device copies; `reconfigure()` is its
  entry point at a process's start.
"""
from __future__ import annotations

from typing import Callable, List, Optional

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


def drop_shards(api, pending: List[tuple]) -> None:
    """Finalize deferred departures: drop the host fragments (and their
    device copies) of shards this process no longer owns.  Called after the
    whole fleet's loads have completed (multihost: after the
    post-reconfigure barrier) so that a new owner never finds its source
    already gone."""
    from featurebase_tpu_torch.executor.plan import drop_fragment_copies
    holder = api.holder
    gone = []
    for (index, shard) in pending:
        idx = holder.index(index)
        if idx is None:
            continue
        for f in idx.fields.values():
            for v in f.views.values():
                frag = v.fragments.pop(shard, None)
                if frag is not None:
                    f.note_shard(v.name, shard, frag.row_ids())
                    frag.release_device()
                    gone.append(frag)
    drop_fragment_copies({id(fr) for fr in gone})


def handoff(api, fetch_snapshot: Callable[[str, int], bytes],
            old_n: int, new_n: int, defer_drops: bool = False) -> dict:
    """Re-home host fragments after a process-count change (reference:
    ApplyDirective diffs directives and loads/unloads shards,
    api_directive.go:144,559).

    `api` is the node's API (restore_shard runs under its index mutate
    gates with generation carry).  For every known shard of every index:
    ownership gained -> load the shard's fragments from
    `fetch_snapshot(index, shard)` (the backup/resync shard-snapshot
    bytes, served by a previous owner); ownership lost -> drop local
    host fragments.  Returns {"loaded": [...], "dropped": [...]}."""
    pid = _policy.process_id
    holder = api.holder
    loaded, dropped = [], []
    for idx in list(holder.indexes.values()):
        for shard in idx.available_shards():
            was = pid in [(owner(idx.name, shard, old_n) + i) % old_n
                          for i in range(_policy.replicas)]
            now = pid in [(owner(idx.name, shard, new_n) + i) % new_n
                          for i in range(_policy.replicas)]
            if now and not was:
                blob = fetch_snapshot(idx.name, shard)
                api.restore_shard(idx.name, shard, blob)
                loaded.append((idx.name, shard))
            elif was and not now:
                dropped.append((idx.name, shard))
    if not defer_drops:
        drop_shards(api, dropped)
        return {"loaded": loaded, "dropped": dropped}
    return {"loaded": loaded, "dropped": [], "pending_drop": dropped}


def _state_path(state_dir: str) -> str:
    import os
    return os.path.join(state_dir, "placement.json")


def previous_n(state_dir: Optional[str]) -> Optional[int]:
    """Mesh size persisted by the last configure() on this data dir."""
    if not state_dir:
        return None
    import json
    import os
    p = _state_path(state_dir)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as fh:
            return int(json.load(fh).get("n_processes", 0)) or None
    except (OSError, ValueError):
        return None


def _persist(state_dir: str, n_processes: int, replicas: int):
    import json
    import os
    os.makedirs(state_dir, exist_ok=True)
    tmp = _state_path(state_dir) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"n_processes": n_processes, "replicas": replicas}, fh)
    os.replace(tmp, _state_path(state_dir))


def reconfigure(api, n_processes: int, process_id: int, replicas: int = 1,
                state_dir: Optional[str] = None,
                fetch_snapshot: Optional[Callable[[str, int], bytes]] = None,
                old_n: Optional[int] = None) -> dict:
    """The membership entry point for mesh-process topology changes.  The
    mesh world size is fixed for a torch.distributed group's lifetime, so
    a size change means
    processes restart into the new world — each calls reconfigure() at
    startup: it reads the previously persisted mesh size from
    `state_dir` (default: the API's data dir), installs the new policy,
    and when the size changed runs handoff(), pulling arriving shards
    from their previous owners (default fetch: the cluster client
    against the peer node at the previous owner's position — mesh
    process i <-> cluster node i).  Departures are DEFERRED: the result
    carries "pending_drop"; the caller runs placement.drop_shards(api,
    pending) after the fleet-wide load barrier so a new owner never
    finds its source already dropped.  Reference flow analog:
    ApplyDirective diff -> loadShard (api_directive.go:144,559)."""
    state_dir = state_dir or getattr(api, "data_dir", None)
    if old_n is None:
        old_n = previous_n(state_dir)
    # (a process new to a resized world has no persisted state — it
    # passes old_n explicitly so its newly owned shards load)
    configure(n_processes, process_id, replicas)
    result = {"loaded": [], "dropped": [], "old_n": old_n}
    if old_n and old_n != n_processes:
        if fetch_snapshot is None:
            if api.cluster is None:
                raise RuntimeError(
                    "placement.reconfigure needs a fetch_snapshot or a "
                    "clustered API to pull re-homed shards from")

            def fetch_snapshot(index, shard, _old_n=old_n):
                nodes = sorted(api.cluster.nodes, key=lambda n: n.id)
                errs = []
                for i in range(_policy.replicas):
                    pid_prev = (owner(index, shard, _old_n) + i) % _old_n
                    if pid_prev < len(nodes):
                        node = nodes[pid_prev]
                        if api.cluster.is_self(node):
                            return api.shard_snapshot_bytes(index, shard)
                        try:
                            return api.cluster.client.shard_snapshot(
                                node.uri, index, shard)
                        except Exception as e:  # noqa: BLE001
                            errs.append(e)
                raise RuntimeError(
                    f"no previous owner reachable for {index}/{shard}: "
                    f"{errs}")
        hres = handoff(api, fetch_snapshot, old_n, n_processes,
                       defer_drops=True)
        result.update(hres)
    if state_dir:
        _persist(state_dir, n_processes, replicas)
    return result
