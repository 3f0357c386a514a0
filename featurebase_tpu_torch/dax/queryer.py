"""DAX Queryer: stateless SQL/PQL front-end.

Own copy of featurebase_tpu/dax/queryer.py over the port's
DistributedExecutor (cluster/distributed.py), so the queryer answers as the
port's cluster does, which is as one node does: Var and Corr merge as
moments, Percentile bisects over the computers' kernel-I′ bins, Limit
cuts the union to its window, Apply and Arrow join a partial a shard.

Mirrors the reference queryer (reference: dax/queryer/queryer.go:34 —
parses/plans against remote schema; orchestrator.go:43 re-implements the
executor scatter-gather but routes shards to computer nodes from the
Controller topology).  Here the same DistributedExecutor used for
monolith-cluster mode drives the fan-out; only the placement source differs
— a DaxTopology that consults the controller's assignment map instead of
jump-hashing over static nodes.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from featurebase_tpu_torch.cluster.client import (InternalClient,
                                                  NodeUnreachable,
                                                  RemoteError)
from featurebase_tpu_torch.cluster.topology import Node
from featurebase_tpu_torch.dax.translate import \
    install_remote_translation
from featurebase_tpu_torch.server.api import API, APIError


class _TopoSnapshot:
    """Duck-typed stand-in for cluster.ClusterSnapshot: placement comes from
    the controller's assignments (reference: ServerlessTopology,
    dax/queryer/orchestrator.go:47 Topologer)."""

    def __init__(self, topo: "DaxTopology"):
        self._topo = topo
        self.replicas = 1

    def shard_nodes(self, index: str, shard: int) -> List[Node]:
        n = self._topo.owner_of(index, shard)
        return [n] if n is not None else []

    def node(self, node_id: str) -> Optional[Node]:
        return self._topo.node(node_id)

    @property
    def nodes(self) -> List[Node]:
        return self._topo.worker_nodes()

    def state(self) -> str:
        return "NORMAL" if self._topo.worker_nodes() else "DOWN"


class DaxTopology:
    """Cluster-interface adapter over the controller topology."""

    node_id = "queryer"

    def __init__(self, controller_uri: str,
                 client: Optional[InternalClient] = None,
                 cache_ttl: float = 1.0):
        self.controller_uri = controller_uri.rstrip("/")
        self.client = client or InternalClient(timeout=30.0)
        self.snapshot = _TopoSnapshot(self)
        self.api: Optional[API] = None  # backref set by DaxQueryerAPI
        self.cache_ttl = cache_ttl
        self._lock = threading.Lock()
        self._topo: dict = {"workers": {}, "assignments": {}}
        self._fetched = 0.0
        self._down: set = set()

    # -- topology cache ----------------------------------------------------------

    def _refresh(self, force: bool = False):
        with self._lock:
            if not force and time.monotonic() - self._fetched < self.cache_ttl:
                return
        topo = self.client._call(self.controller_uri, "GET", "/dax/topology")
        with self._lock:
            self._topo = topo
            self._fetched = time.monotonic()

    def worker_nodes(self) -> List[Node]:
        self._refresh()
        with self._lock:
            return [Node(w, uri,
                         state="DOWN" if w in self._down else "STARTED")
                    for w, uri in sorted(self._topo["workers"].items())]

    def node(self, node_id: str) -> Optional[Node]:
        self._refresh()
        with self._lock:
            uri = self._topo["workers"].get(node_id)
        if uri is None:
            return None
        return Node(node_id, uri,
                    state="DOWN" if node_id in self._down else "STARTED")

    def owner_of(self, index: str, shard: int) -> Optional[Node]:
        self._refresh()
        with self._lock:
            wid = self._topo["assignments"].get(index, {}).get(str(shard))
        if wid is None or wid in self._down:
            # unassigned (new shard) or owner down: ask the controller
            out = self.client._call(self.controller_uri, "POST",
                                    "/dax/assign-shard",
                                    {"table": index, "shard": shard})
            self._refresh(force=True)
            wid = out["worker"]
            if wid in self._down:
                return None
            return Node(wid, out["uri"])
        return self.node(wid)

    # -- Cluster interface used by DistributedExecutor / API ----------------------

    def first_live(self, owners: List[Node]) -> Optional[Node]:
        for n in owners:
            if n is not None and n.state != "DOWN":
                return n
        return None

    def is_self(self, node: Node) -> bool:
        return False  # the queryer holds no shards

    def mark_down(self, node_id: str):
        with self._lock:
            self._down.add(node_id)

    def mark_up(self, node_id: str):
        with self._lock:
            self._down.discard(node_id)

    def clear_down(self):
        with self._lock:
            self._down.clear()

    def all_shards(self, api, index: str) -> List[int]:
        self._refresh(force=True)
        with self._lock:
            m = self._topo["assignments"].get(index, {})
            return sorted(int(s) for s in m)

    def note_shards(self, index: str, shards):
        pass  # controller registry is authoritative

    def forget_index(self, index: str):
        pass

    def broadcast(self, msg: dict, sync: bool = True):
        """Schema changes route to the controller which re-directives the
        computers (reference: queryer -> controller Schemar)."""
        t = msg.get("type", "")
        if t in ("create_index", "delete_index", "create_field",
                 "delete_field"):
            self.client._call(self.controller_uri, "POST", "/dax/schema",
                              {"type": "set_schema",
                               "schema": self.api.schema()})
            install_remote_translation(self.api, self.controller_uri,
                                       self.client)
        elif t in ("create_view", "delete_view"):
            self.client._call(self.controller_uri, "POST", "/dax/schema", msg)

    def route_create_index_keys(self, api, index: str, keys) -> Dict[str, int]:
        return {k: int(v) for k, v in self.client._call(
            self.controller_uri, "POST", f"/dax/translate/{index}/create",
            {"keys": list(keys)}).items()}

    def route_create_field_keys(self, api, index: str, field: str,
                                keys) -> Dict[str, int]:
        return {k: int(v) for k, v in self.client._call(
            self.controller_uri, "POST",
            f"/dax/translate/{index}/{field}/create",
            {"keys": list(keys)}).items()}


class DaxQueryerAPI(API):
    def __init__(self, controller_uri: str, **kw):
        topo = DaxTopology(controller_uri)
        super().__init__(cluster=topo, **kw)
        topo.api = self
        self.controller_uri = controller_uri.rstrip("/")
        self.sync_schema()

    def sync_schema(self):
        try:
            out = self.cluster.client._call(self.controller_uri, "GET",
                                            "/dax/schema")
        except (NodeUnreachable, RemoteError):
            return
        if out.get("schema"):
            self.holder.apply_schema(out["schema"])
        self.holder.sql_views = dict(out.get("views") or {})
        install_remote_translation(self, self.controller_uri,
                                   self.cluster.client)

    def _index(self, name: str):
        idx = self.holder.index(name)
        if idx is None:
            self.sync_schema()
            idx = self.holder.index(name)
        if idx is None:
            raise APIError(f"index not found: {name}", 404)
        return idx
