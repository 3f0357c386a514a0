"""Cluster runtime: membership, schema broadcast, key-translation routing.

Own copy of featurebase_tpu/cluster/cluster.py.  It takes the place of the
reference's etcd-backed DisCo and broadcaster (reference: disco/disco.go:35,
etcd/embed.go, broadcast.go:30) with a membership table given at start,
joins and leaves that a majority admits, and HTTP health probes.  Liveness
is dynamic: an unreachable node is marked DOWN and queries fail over to its
replicas (reference: executor.go:6503).

Key translation follows the reference's primary-per-partition write scheme
(reference: cluster.go:676 createIndexKeys -> PrimaryPartitionNode;
snapshot.go:136 PrimaryFieldTranslationNode for field keys), with
synchronous replication of new entries to every node so reads and
result-translation stay node-local.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from featurebase_tpu_torch.cluster.client import (InternalClient, NodeUnreachable,
                                            RemoteError)
from featurebase_tpu_torch.cluster.topology import (STATE_DOWN, STATE_STARTED,
                                              ClusterSnapshot, Node)


class ClusterQuorumError(Exception):
    """A topology change was attempted without a reachable majority."""


class Cluster:
    """One node's view of the cluster (reference: cluster.go:29 cluster)."""

    def __init__(self, node_id: str, nodes: List[dict], replicas: int = 1,
                 client: Optional[InternalClient] = None):
        node_objs = [Node.from_json(n) if isinstance(n, dict) else n
                     for n in nodes]
        self.node_id = node_id
        self.snapshot = ClusterSnapshot(node_objs, replicas=replicas)
        self.client = client or InternalClient()
        self._lock = threading.Lock()
        # last-known available shards per index: stands in for the
        # reference's etcd shard registry (disco.Sharder) so a down node's
        # shards are still *known* (and error, rather than silently vanish,
        # when unreplicated; reference: executor fails when no owner is live)
        self._shard_cache: Dict[str, set] = {}
        me = self.snapshot.node(node_id)
        if me is None:
            raise ValueError(f"node id {node_id!r} not in cluster node list")
        self.self_node = me

    # -- membership ------------------------------------------------------------

    @property
    def nodes(self) -> List[Node]:
        return self.snapshot.nodes

    def peers(self) -> List[Node]:
        return [n for n in self.nodes if n.id != self.node_id]

    def live_peers(self) -> List[Node]:
        return [n for n in self.peers() if n.state != STATE_DOWN]

    def is_self(self, node: Node) -> bool:
        return node.id == self.node_id

    # -- dynamic membership (reference analogs: etcd watchNodes rebuilds the
    # cluster snapshot, etcd/embed.go:711; DAX Controller.RegisterWorker +
    # rebalance, dax/controller/controller.go:30 — the monolith reference
    # removed resize, broadcast.go:63, so elastic join is a DAX-role feature
    # folded into the cluster layer here) ----------------------------------

    def _apply_topology_locked(self, nodes, replicas=None, version=None,
                               origin=None):
        """Core topology install; caller holds self._lock.  Returns the
        previous snapshot, or None if (version, origin) is stale (a delayed
        older broadcast must not overwrite newer membership)."""
        prev = self.snapshot
        if version is not None and \
                (version, origin or "") <= (prev.version, prev.origin):
            return None
        node_objs = [Node.from_json(n) if isinstance(n, dict) else n
                     for n in nodes]
        for n in node_objs:
            old = prev.node(n.id)
            if old is not None:
                n.state = old.state
        self.snapshot = ClusterSnapshot(
            node_objs, replicas=replicas or prev.replicas,
            version=prev.version + 1 if version is None else version,
            origin=self.node_id if origin is None else origin)
        me = self.snapshot.node(self.node_id)
        if me is not None:
            self.self_node = me
        return prev

    def apply_topology(self, nodes, replicas: Optional[int] = None,
                       version: Optional[int] = None,
                       origin: Optional[str] = None):
        """Install a new membership list; placement (jump hash over the
        sorted node list) re-derives automatically.  Returns the previous
        snapshot so callers can diff ownership for rebalance, or None when
        the message carried a stale (version, origin) epoch."""
        with self._lock:
            return self._apply_topology_locked(nodes, replicas, version,
                                               origin)

    def _require_quorum(self, action: str):
        """Topology changes require a reachable majority of the current
        membership (self counts), so a partitioned minority can't admit
        or retire nodes and diverge the cluster (the etcd-raft role for
        admin operations; reference: disco/etcd single consistent view).
        2-node clusters can force-remove a dead peer with force=True."""
        peers = self.peers()
        if not peers:
            return
        reachable = 1 + sum(1 for n in peers if self.client.health(n.uri))
        total = len(peers) + 1
        if reachable * 2 <= total:
            raise ClusterQuorumError(
                f"cannot {action}: only {reachable}/{total} members "
                "reachable (need a majority; pass force=true to override)")

    def join_node(self, node, force: bool = False):
        """Admit (or re-admit) a node and broadcast the new topology to
        every member, including the joiner.  Returns (topology, previous
        snapshot).  The merged node list is built under the lock so two
        concurrent joins can't each drop the other's node (epoch + origin
        tiebreak then keeps receivers' views convergent)."""
        nd = Node.from_json(node) if isinstance(node, dict) else node
        if not force:
            self._require_quorum("admit a node")
        with self._lock:
            nodes = [n.to_json() for n in self.snapshot.nodes
                     if n.id != nd.id]
            nodes.append(nd.to_json())
            prev = self._apply_topology_locked(nodes)
            topo = self.snapshot.to_json()
        self.broadcast({"type": "topology", **topo})
        return topo, prev

    def remove_node(self, node_id: str, force: bool = False):
        """Retire a node and broadcast the shrunk topology."""
        if not force:
            self._require_quorum("retire a node")
        with self._lock:
            nodes = [n.to_json() for n in self.snapshot.nodes
                     if n.id != node_id]
            if not nodes:
                raise ValueError("cannot remove the last cluster node")
            prev = self._apply_topology_locked(nodes)
            topo = self.snapshot.to_json()
        self.broadcast({"type": "topology", **topo})
        return topo, prev

    def mark_down(self, node_id: str):
        n = self.snapshot.node(node_id)
        if n is not None:
            n.state = STATE_DOWN

    def mark_up(self, node_id: str):
        n = self.snapshot.node(node_id)
        if n is not None:
            n.state = STATE_STARTED

    def probe(self) -> str:
        """Health-check all peers, update states, return cluster state
        (reference: etcd heartbeat watcher role, etcd/embed.go:458)."""
        for n in self.peers():
            n.state = (STATE_STARTED if self.client.health(n.uri)
                       else STATE_DOWN)
        return self.snapshot.state()

    def start_heartbeat(self, api, interval: float = 2.0,
                        resync_every: int = 5):
        """Background liveness loop: probes peers; when a peer recovers
        (DOWN -> up) re-pulls schema/translate state, and every
        `resync_every`-th cycle runs the shard anti-entropy pass so a node
        that was down (or missed replica writes) converges without a restart
        (reference: etcd heartbeat leases + holderSyncer holder.go:1303)."""
        def loop():
            cycle = 0
            while not self._stop_heartbeat.is_set():
                before = {n.id: n.state for n in self.peers()}
                self.probe()
                came_up = [n for n in self.peers()
                           if before.get(n.id) == STATE_DOWN
                           and n.state == STATE_STARTED]
                if came_up or not self._synced_once:
                    if self.sync_from_peers(api, retries=1):
                        self._synced_once = True
                cycle += 1
                if came_up or cycle % resync_every == 0:
                    try:
                        api.resync_shards()
                    except Exception:  # noqa: BLE001 — retried next cycle
                        pass
                self._stop_heartbeat.wait(interval)

        self._stop_heartbeat = threading.Event()
        self._synced_once = False
        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._heartbeat_thread = t
        return t

    def stop_heartbeat(self):
        ev = getattr(self, "_stop_heartbeat", None)
        if ev is not None:
            ev.set()

    def schema_leader(self) -> Optional[Node]:
        """Deterministic reachable leader for schema ops: the lowest node
        id that answers /health (self counts as reachable).  Commit safety
        comes from the leader's quorum check, not from uniqueness — a
        minority partition may pick its own leader but that leader cannot
        commit (cluster/schemalog.py)."""
        for n in sorted(self.nodes, key=lambda x: x.id):
            if self.is_self(n) or self.client.health(n.uri):
                return n
        return None

    def first_live(self, owners: List[Node]) -> Optional[Node]:
        """First non-DOWN owner — replica failover order (reference:
        executor.go:6503)."""
        for n in owners:
            if n.state != STATE_DOWN:
                return n
        return None

    # -- control-plane broadcast (reference: broadcast.go SendSync) -------------

    def broadcast(self, msg: dict, sync: bool = True):
        """POST a typed message to every peer (even DOWN-marked ones — a
        recovered node must not silently miss schema changes; connection
        failures just mark it DOWN again).  Application errors propagate
        when sync."""
        for n in self.peers():
            try:
                self.client.cluster_message(n.uri, msg)
                self.mark_up(n.id)
            except NodeUnreachable:
                self.mark_down(n.id)
            except RemoteError:
                if sync:
                    raise

    # -- key translation routing -------------------------------------------------

    def route_create_index_keys(self, api, index: str,
                                keys: List[str]) -> Dict[str, int]:
        """Group keys by key partition; create on each partition's primary;
        primaries replicate to all nodes synchronously."""
        by_node: Dict[str, List[str]] = {}
        node_by_id: Dict[str, Node] = {}
        for k in keys:
            owner = self.snapshot.primary_key_node(index, k)
            owner = self.first_live([owner] if owner else [])
            if owner is None:
                raise NodeUnreachable("no live node owns key partition")
            by_node.setdefault(owner.id, []).append(k)
            node_by_id[owner.id] = owner
        out: Dict[str, int] = {}
        for nid, ks in by_node.items():
            node = node_by_id[nid]
            if self.is_self(node):
                created = api.primary_create_index_keys(index, ks)
            else:
                created = self.client.translate_keys(node.uri, index, ks,
                                                     create=True)
            out.update({k: int(v) for k, v in created.items()})
        return out

    def route_find_index_keys(self, api, index: str,
                              keys: List[str]) -> Dict[str, int]:
        # replication makes every node's store complete; stay local
        return api.holder.index(index).translate_store.find_keys(keys)

    def route_create_field_keys(self, api, index: str, field: str,
                                keys: List[str]) -> Dict[str, int]:
        owner = self.snapshot.primary_field_translation_node()
        owner = self.first_live([owner] if owner else [])
        if owner is None:
            raise NodeUnreachable("no live field-translation primary")
        if self.is_self(owner):
            return api.primary_create_field_keys(index, field, keys)
        return {k: int(v) for k, v in self.client.translate_keys(
            owner.uri, index, keys, create=True, field=field).items()}

    def replicate_index_keys(self, index: str, entries: Dict[str, int]):
        for n in self.live_peers():
            try:
                self.client.replicate_keys(n.uri, index, entries)
            except NodeUnreachable:
                self.mark_down(n.id)

    def replicate_field_keys(self, index: str, field: str,
                             entries: Dict[str, int]):
        for n in self.live_peers():
            try:
                self.client.replicate_keys(n.uri, index, entries, field=field)
            except NodeUnreachable:
                self.mark_down(n.id)

    # -- shard metadata ------------------------------------------------------------

    def all_shards(self, api, index: str) -> List[int]:
        """Union of available shards across live nodes plus the last-known
        registry (reference: etcd Sharder per-field available-shards;
        disco.go:113)."""
        shards = set(api.holder.index(index).available_shards())
        for n in self.live_peers():
            try:
                shards.update(self.client.shards(n.uri, index))
            except NodeUnreachable:
                self.mark_down(n.id)
        with self._lock:
            cached = self._shard_cache.setdefault(index, set())
            cached.update(shards)
            return sorted(cached)

    def note_shards(self, index: str, shards):
        """Register shards this node has routed writes into (keeps the
        registry current even before any read touches them)."""
        with self._lock:
            self._shard_cache.setdefault(index, set()).update(
                int(s) for s in shards)

    def forget_index(self, index: str):
        with self._lock:
            self._shard_cache.pop(index, None)

    # -- startup sync ---------------------------------------------------------------

    def sync_from_peers(self, api, retries: int = 3, delay: float = 0.2):
        """Pull schema + translate state from the first reachable peer
        (reference: holder.Open loads schema from etcd Schemator)."""
        for _ in range(retries):
            for n in self.peers():
                try:
                    schema = self.client.schema(n.uri)
                    if schema:
                        api.apply_schema(schema)
                    snap = self.client._call(n.uri, "GET",
                                             "/internal/translate/snapshot")
                    api.apply_translate_snapshot(snap)
                    try:
                        # adopt the peer's schema-log position WITHOUT
                        # replaying (the schema pull above already reflects
                        # the log's end state; replaying old entries could
                        # resurrect deleted objects)
                        log = self.client._call(
                            n.uri, "GET", "/internal/schema/log?from=0")
                        api.schema_log.install(log.get("entries", []),
                                               log.get("applied", 0))
                    except (NodeUnreachable, RemoteError):
                        pass
                    return True
                except (NodeUnreachable, RemoteError):
                    continue
            time.sleep(delay)
        return False
