"""String-key <-> ID translation stores.

Replaces the reference's BoltDB translate stores (reference: translate.go:43
TranslateStore iface, translate_boltdb.go; partitioned ID generation
translate.go:103 GenerateNextPartitionedID) with host-side hash maps plus a
JSON snapshot for durability.  The partitioning scheme is kept bit-compatible
with the reference so external tooling's placement assumptions hold:

- key partition  = fnv64a(index + key) % PARTITION_N
  (reference: disco/snapshot.go KeyToKeyPartition)
- shard partition = fnv64a(index + bigendian8(shard)) % PARTITION_N
  (reference: disco/snapshot.go ShardToShardPartition)
- a column key in partition p is assigned the next free ID whose shard's
  shard-partition == p (reference: translate.go GenerateNextPartitionedID)
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

from featurebase_tpu_torch.core.consts import PARTITION_N, SHARD_WIDTH

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def fnv64a(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def fnv64a_batch(prefix: bytes, items: list) -> "np.ndarray":
    """Vectorized FNV-1a over a batch of byte strings sharing a prefix.

    FNV is sequential per byte but embarrassingly parallel ACROSS keys:
    equal-length keys advance in lockstep as one uint64 numpy column op
    per byte position (unsigned wraparound is numpy-exact).  The Python
    per-byte loop cost ~5us/key and bounded keyed ingest at ~160k
    records/s (reference bottleneck analog: batch.go:860 doTranslation).
    """
    import numpy as np
    h0 = _FNV_OFFSET
    for b in prefix:
        h0 ^= b
        h0 = (h0 * _FNV_PRIME) & _MASK64
    out = np.empty(len(items), dtype=np.uint64)
    by_len: Dict[int, list] = {}
    for i, kb in enumerate(items):
        by_len.setdefault(len(kb), []).append(i)
    prime = np.uint64(_FNV_PRIME)
    for length, idxs in by_len.items():
        if length == 0:
            out[np.array(idxs)] = np.uint64(h0)
            continue
        arr = np.frombuffer(
            b"".join(items[i] for i in idxs), dtype=np.uint8
        ).reshape(len(idxs), length)
        h = np.full(len(idxs), h0, dtype=np.uint64)
        for j in range(length):
            h ^= arr[:, j].astype(np.uint64)
            h *= prime
        out[np.array(idxs)] = h
    return out


def shard_to_shard_partition(index: str, shard: int,
                             partition_n: int = PARTITION_N) -> int:
    return fnv64a(index.encode() + shard.to_bytes(8, "big")) % partition_n


def key_to_key_partition(index: str, key: str,
                         partition_n: int = PARTITION_N) -> int:
    """The key's partition (reference: disco/snapshot.go KeyToKeyPartition),
    which `presort` routes records by."""
    return fnv64a(index.encode() + key.encode()) % partition_n


def jump_hash(key: int, n_buckets: int) -> int:
    """Google jump consistent hash (reference: disco/hasher.go:16): the
    owner of a partition among n_buckets, moving only 1/n of the keys when
    a bucket is added."""
    b, j = -1, 0
    key &= _MASK64
    while j < n_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK64
        j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


def generate_next_partitioned_id(index: str, prev: int, partition_id: int,
                                 partition_n: int = PARTITION_N) -> int:
    """The next column id after `prev` whose shard hashes to partition_id
    (reference: translate.go:103 GenerateNextPartitionedID)."""
    if partition_id == -1:
        return prev + 1
    id_ = prev + 1
    while shard_to_shard_partition(index, id_ // SHARD_WIDTH, partition_n) \
            != partition_id:
        id_ += SHARD_WIDTH
    return id_


class TranslatePartition:
    """One key partition's bidirectional map."""

    # (index, shard) -> shard partition, shared across partitions: the
    # next-id probe re-hashes the same shard ids constantly (reference:
    # translate.go:103 GenerateNextPartitionedID)
    _shard_part_cache: Dict[tuple, int] = {}

    def __init__(self, index: str, partition_id: int):
        self.index = index
        self.partition_id = partition_id
        self.key_to_id: Dict[str, int] = {}
        self.id_to_key: Dict[int, str] = {}
        self.max_id = 0

    def _next_id(self) -> int:
        if self.partition_id == -1:
            return self.max_id + 1
        id_ = self.max_id + 1
        cache = self._shard_part_cache
        while True:
            shard = id_ // SHARD_WIDTH
            ck = (self.index, shard)
            p = cache.get(ck)
            if p is None:
                p = shard_to_shard_partition(self.index, shard)
                cache[ck] = p
            if p == self.partition_id:
                return id_
            id_ += SHARD_WIDTH

    def create(self, key: str) -> int:
        """The key's id, assigned on first sight."""
        id_ = self.key_to_id.get(key)
        if id_ is not None:
            return id_
        id_ = self._next_id()
        self.max_id = id_
        self.key_to_id[key] = id_
        self.id_to_key[id_] = key
        return id_


def _checksum(key_to_id: Dict[str, int]) -> int:
    ck = 0
    for k, v in key_to_id.items():
        ck ^= fnv64a(f"{k}={v}".encode())
    return ck


class IndexTranslateStore:
    """Per-index column-key translation, 256-way partitioned."""

    def __init__(self, index: str):
        self.index = index
        self._lock = threading.RLock()
        self.partitions: Dict[int, TranslatePartition] = {}

    def _part_for_key(self, key: str) -> TranslatePartition:
        p = key_to_key_partition(self.index, key)
        part = self.partitions.get(p)
        if part is None:
            part = TranslatePartition(self.index, p)
            self.partitions[p] = part
        return part

    def _parts_for_keys(self, keys: list, create: bool) -> list:
        """Partition objects (or None when absent and not creating) for a
        key batch via ONE vectorized hash pass (fnv64a_batch) instead of
        a per-key Python FNV loop."""
        pids = fnv64a_batch(self.index.encode(),
                            [k.encode() for k in keys]) % PARTITION_N
        out = []
        for pid in pids:
            pid = int(pid)
            part = self.partitions.get(pid)
            if part is None and create:
                part = TranslatePartition(self.index, pid)
                self.partitions[pid] = part
            out.append(part)
        return out

    def create_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        keys = list(keys)
        with self._lock:
            # one vectorized hash pass, then a tight loop with bound
            # locals (method dispatch per key measured ~40% of bulk
            # create time — this is THE keyed-ingest hot path, reference
            # bottleneck analog batch.go:860 doTranslation)
            pids = (fnv64a_batch(self.index.encode(),
                                 [k.encode() for k in keys])
                    % PARTITION_N).tolist()
            partitions = self.partitions
            index = self.index
            out = {}
            for k, pid in zip(keys, pids):
                part = partitions.get(pid)
                if part is None:
                    part = partitions[pid] = TranslatePartition(index, pid)
                id_ = part.key_to_id.get(k)
                if id_ is None:
                    id_ = part._next_id()
                    part.max_id = id_
                    part.key_to_id[k] = id_
                    part.id_to_key[id_] = k
                out[k] = id_
            return out

    def find_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        keys = list(keys)
        with self._lock:
            out = {}
            for k, part in zip(keys, self._parts_for_keys(keys,
                                                          create=False)):
                if part is None:
                    continue
                id_ = part.key_to_id.get(k)
                if id_ is not None:
                    out[k] = id_
            return out

    def translate_ids(self, ids: Iterable[int]) -> List[Optional[str]]:
        with self._lock:
            out = []
            for id_ in ids:
                found = None
                for part in self.partitions.values():
                    found = part.id_to_key.get(int(id_))
                    if found is not None:
                        break
                out.append(found)
            return out

    def apply_entries(self, entries: Dict[str, int]):
        """Install key -> id pairs verbatim: a WAL replay's "keys" entry, or
        a partition primary's new keys replicated to this node (reference:
        translate entry streaming, holder.go:1303)."""
        keys = list(entries)
        with self._lock:
            for k, part in zip(keys, self._parts_for_keys(keys,
                                                          create=True)):
                id_ = int(entries[k])
                part.key_to_id[k] = id_
                part.id_to_key[id_] = k
                part.max_id = max(part.max_id, id_)

    def checksum(self) -> list:
        """[entry count, content checksum]: the unit that translate
        anti-entropy compares (a list, so that a local value and a peer's
        decoded JSON compare equal)."""
        with self._lock:
            n = 0
            ck = 0
            for part in self.partitions.values():
                n += len(part.key_to_id)
                ck ^= _checksum(part.key_to_id)
            return [n, ck]

    def to_json(self):
        return {str(p): {"keys": part.key_to_id, "max_id": part.max_id}
                for p, part in self.partitions.items()}

    @classmethod
    def from_json(cls, index: str, d: dict) -> "IndexTranslateStore":
        st = cls(index)
        for p, pd in d.items():
            part = TranslatePartition(index, int(p))
            part.key_to_id = dict(pd["keys"])
            part.id_to_key = {v: k for k, v in part.key_to_id.items()}
            part.max_id = pd["max_id"]
            st.partitions[int(p)] = part
        return st


class FieldTranslateStore:
    """Per-field row-key translation (single primary, unpartitioned;
    reference: field translate store, cluster.go:258 findFieldKeys)."""

    def __init__(self, index: str, field: str):
        self.index = index
        self.field = field
        self._lock = threading.RLock()
        self.key_to_id: Dict[str, int] = {}
        self.id_to_key: Dict[int, str] = {}
        self.max_id = 0

    def create_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        with self._lock:
            out = {}
            for k in keys:
                id_ = self.key_to_id.get(k)
                if id_ is None:
                    self.max_id += 1
                    id_ = self.max_id
                    self.key_to_id[k] = id_
                    self.id_to_key[id_] = k
                out[k] = id_
            return out

    def find_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        with self._lock:
            return {k: self.key_to_id[k] for k in keys if k in self.key_to_id}

    def translate_ids(self, ids: Iterable[int]) -> List[Optional[str]]:
        with self._lock:
            return [self.id_to_key.get(int(i)) for i in ids]

    def match_like(self, pattern: str) -> List[int]:
        """LIKE pushdown: the ids of the keys matching a SQL LIKE pattern,
        in one pass over the store (reference like.go:13 planLike)."""
        import re
        rx = re.compile("^" + re.escape(pattern).replace("%", ".*")
                        .replace("_", ".") + "$")
        with self._lock:
            return [id_ for k, id_ in self.key_to_id.items() if rx.match(k)]

    def apply_entries(self, entries: Dict[str, int]):
        with self._lock:
            for k, id_ in entries.items():
                self.key_to_id[k] = int(id_)
                self.id_to_key[int(id_)] = k
                self.max_id = max(self.max_id, int(id_))

    def checksum(self) -> list:
        with self._lock:
            return [len(self.key_to_id), _checksum(self.key_to_id)]

    def to_json(self):
        return {"keys": self.key_to_id, "max_id": self.max_id}

    @classmethod
    def from_json(cls, index: str, field: str, d: dict) -> "FieldTranslateStore":
        st = cls(index, field)
        st.key_to_id = dict(d["keys"])
        st.id_to_key = {v: k for k, v in st.key_to_id.items()}
        st.max_id = d["max_id"]
        return st
