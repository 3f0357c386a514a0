"""Cluster topology: nodes, partitions, shard and key placement.

Own copy of featurebase_tpu/cluster/topology.py (reference: the
ClusterSnapshot of disco/snapshot.go:24-135, cluster.go:29-107): shard ->
partition by FNV-1a(index, shard) mod 256, partition -> its replica nodes by
jump consistent hash over the sorted node set, and 256-way key partitions
with one primary for writes.  Both packages derive the same placement from
the same node list, so a node of either owns the same shards.

A node is one process with its API: one CUDA device, or a mesh of devices
(parallel/); the cluster splits shards over nodes, the mesh over a node's
devices.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from featurebase_tpu_torch.core.consts import PARTITION_N
from featurebase_tpu_torch.storage.translate import (jump_hash,
                                                     key_to_key_partition,
                                                     shard_to_shard_partition)

# Node states (reference: disco/disco.go:53-71)
STATE_UNKNOWN = "UNKNOWN"
STATE_STARTING = "STARTING"
STATE_STARTED = "STARTED"
STATE_DOWN = "DOWN"

# Cluster states
CLUSTER_NORMAL = "NORMAL"
CLUSTER_DEGRADED = "DEGRADED"
CLUSTER_DOWN = "DOWN"


class Node:
    """One cluster member (reference: disco.Node, topology.go)."""

    __slots__ = ("id", "uri", "state", "is_primary")

    def __init__(self, id: str, uri: str, state: str = STATE_STARTED,
                 is_primary: bool = False):
        self.id = id
        self.uri = uri.rstrip("/")
        self.state = state
        self.is_primary = is_primary

    def to_json(self) -> dict:
        return {"id": self.id, "uri": self.uri, "state": self.state,
                "isPrimary": self.is_primary}

    @classmethod
    def from_json(cls, d: dict) -> "Node":
        return cls(d["id"], d["uri"], d.get("state", STATE_STARTED),
                   d.get("isPrimary", False))

    def __repr__(self):
        return f"Node({self.id}@{self.uri},{self.state})"


class ClusterSnapshot:
    """A view of the membership that placement decisions read (reference:
    disco.ClusterSnapshot, snapshot.go:24)."""

    def __init__(self, nodes: List[Node], replicas: int = 1,
                 partition_n: int = PARTITION_N, version: int = 0,
                 origin: str = ""):
        # sorted by id, so that every node derives the same placement
        self.nodes = sorted(nodes, key=lambda n: n.id)
        self.replicas = max(1, min(replicas, len(self.nodes) or 1))
        self.partition_n = partition_n
        # a (version, origin) epoch: receivers ignore a topology message
        # whose epoch is not newer than the one applied, so a delayed
        # older broadcast never overwrites newer membership
        self.version = version
        self.origin = origin
        self._by_id: Dict[str, Node] = {n.id: n for n in self.nodes}
        if self.nodes:
            self.nodes[0].is_primary = True

    def node(self, node_id: str) -> Optional[Node]:
        return self._by_id.get(node_id)

    @property
    def primary(self) -> Optional[Node]:
        return self.nodes[0] if self.nodes else None

    def partition_nodes(self, partition: int) -> List[Node]:
        """A partition's replicas: the jump-hash start and the next
        replicas - 1 nodes (reference: snapshot.go:117 PartitionNodes)."""
        n = len(self.nodes)
        if n == 0:
            return []
        start = jump_hash(partition, n)
        return [self.nodes[(start + i) % n] for i in range(self.replicas)]

    def shard_partition(self, index: str, shard: int) -> int:
        return shard_to_shard_partition(index, shard, self.partition_n)

    def shard_nodes(self, index: str, shard: int) -> List[Node]:
        """Every owner of a shard, primary first (reference: snapshot.go
        ShardNodes)."""
        return self.partition_nodes(self.shard_partition(index, shard))

    def key_partition(self, index: str, key: str) -> int:
        return key_to_key_partition(index, key, self.partition_n)

    def key_nodes(self, index: str, key: str) -> List[Node]:
        return self.partition_nodes(self.key_partition(index, key))

    def primary_key_node(self, index: str, key: str) -> Optional[Node]:
        """The write owner of a column key (reference: cluster.go:676
        createIndexKeys -> PrimaryPartitionNode)."""
        owners = self.key_nodes(index, key)
        return owners[0] if owners else None

    def primary_field_translation_node(self) -> Optional[Node]:
        """The one primary of field (row) keys: partition 0's (reference:
        snapshot.go:136 PrimaryFieldTranslationNode)."""
        owners = self.partition_nodes(0)
        return owners[0] if owners else None

    def owns_shard(self, node_id: str, index: str, shard: int) -> bool:
        return any(n.id == node_id for n in self.shard_nodes(index, shard))

    def state(self) -> str:
        """NORMAL with every node up; DEGRADED while replication covers the
        down nodes; DOWN otherwise (reference: disco/disco.go:53-71)."""
        down = sum(1 for n in self.nodes if n.state == STATE_DOWN)
        if down == 0:
            return CLUSTER_NORMAL
        if down < self.replicas:
            return CLUSTER_DEGRADED
        return CLUSTER_DOWN

    def to_json(self) -> dict:
        return {"nodes": [n.to_json() for n in self.nodes],
                "replicas": self.replicas,
                "version": self.version, "origin": self.origin}
