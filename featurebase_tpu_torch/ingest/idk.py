"""Streaming ingest kit (the IDK role).

Mirrors the reference's idk.Main pipeline (reference: idk/ingest.go:59 Main
config, :255 Run, :319 runIngester source poll loop, :1710 batchFromSchema
recordizers, :1062 commitRecord offset commit): a pluggable Source yields
records, Recordizers map raw values onto typed fields, full batches flow
through the shard-transactional bulk import path, and the source offset is
committed only AFTER the batch lands — so a crash between import and commit
replays the uncommitted tail.

Exactly-once on replay:
- explicit record ids: re-importing the same (id, field, value) bits is
  idempotent by Set semantics — replays cannot create duplicates.
- auto ids: each batch reserves its id range through the (key, session,
  offset) ID allocator with offset = the source's committed checkpoint
  (reference: idalloc.go reserveIDs; idk auto-id path), so a replayed batch
  receives the SAME id range it got before the crash.

Sources implement the Kafka consumer shape (poll/commit of a checkpoint);
FileTailSource (JSONL + sidecar offset file) and GeneratorSource (seeded
synthetic data, the idk/datagen role) stand in where no broker exists.

Own copy of featurebase_tpu/ingest/idk.py.
"""
from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, Iterable, List, Optional, Tuple

from featurebase_tpu_torch.ingest.batch import Batch
from featurebase_tpu_torch.server.api import API, APIError


class Source:
    """Kafka-consumer-shaped source: poll records after the current
    checkpoint, then commit a new checkpoint once they are durably
    imported (reference: idk.Source iface, idk/interfaces.go)."""

    def poll(self, max_records: int) -> List[dict]:
        raise NotImplementedError

    def checkpoint(self) -> int:
        """Committed position (survives restarts)."""
        raise NotImplementedError

    def commit(self) -> None:
        """Persist the position just past the last polled batch."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class FileTailSource(Source):
    """Tails a JSONL file; the committed byte offset lives in a sidecar
    file so a restarted ingester resumes exactly after the last committed
    batch (the Kafka-partition-offset analog)."""

    def __init__(self, path: str, offset_path: Optional[str] = None):
        self.path = path
        self.offset_path = offset_path or path + ".offset"
        self._committed = 0
        self._batches = 0
        if os.path.exists(self.offset_path):
            with open(self.offset_path) as fh:
                data = json.load(fh)
                self._committed = int(data.get("pos", 0))
                self._batches = int(data.get("batches", 0))
        self._pos = self._committed

    def poll(self, max_records: int) -> List[dict]:
        out: List[dict] = []
        with open(self.path, "rb") as fh:
            fh.seek(self._pos)
            while len(out) < max_records:
                line = fh.readline()
                if not line or not line.endswith(b"\n"):
                    break  # incomplete tail: wait for the writer
                self._pos = fh.tell()
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def checkpoint(self) -> int:
        return self._batches

    def commit(self) -> None:
        self._committed = self._pos
        self._batches += 1
        tmp = self.offset_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"pos": self._committed, "batches": self._batches}, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.offset_path)


class GeneratorSource(Source):
    """Deterministic synthetic records (the idk/datagen role): record i is
    a pure function of (seed, i), so any replay regenerates identical
    data."""

    def __init__(self, total: int, seed: int = 0,
                 schema: Optional[Dict[str, str]] = None):
        self.total = total
        self.seed = seed
        self.schema = schema or {"segment": "set", "value": "int"}
        self._committed = 0
        self._cursor = 0

    def record(self, i: int) -> dict:
        h = (i * 2654435761 + self.seed) & 0xFFFFFFFF
        rec: dict = {"id": i}
        for name, kind in self.schema.items():
            if kind == "int":
                rec[name] = (h % 1000) - 100
            else:
                rec[name] = h % 8
        return rec

    def poll(self, max_records: int) -> List[dict]:
        end = min(self._cursor + max_records, self.total)
        out = [self.record(i) for i in range(self._cursor, end)]
        self._cursor = end
        return out

    def checkpoint(self) -> int:
        return self._committed

    def commit(self) -> None:
        self._committed = self._cursor


class SQLSource(Source):
    """Incremental SQL-database source (reference: idk's molecula-consumer-
    sql / sql source, idk/sql): polls rows past a monotonic cursor column
    and commits the high-water mark, so a restarted ingester resumes after
    the last durably imported batch.

    db: a DB-API connection factory or sqlite path; query must select a
    monotonically increasing cursor as its FIRST column, e.g.
    `SELECT rowid, id, segment, value FROM events WHERE rowid > ?
     ORDER BY rowid LIMIT ?`."""

    def __init__(self, db, query: str, columns: List[str],
                 checkpoint_path: Optional[str] = None):
        if isinstance(db, str):
            import sqlite3
            self._conn = sqlite3.connect(db, check_same_thread=False)
        else:
            self._conn = db
        self.query = query
        self.columns = columns
        self.checkpoint_path = checkpoint_path
        self._committed = 0
        if checkpoint_path and os.path.exists(checkpoint_path):
            with open(checkpoint_path) as fh:
                self._committed = int(json.load(fh)["cursor"])
        self._pos = self._committed

    def poll(self, max_records: int) -> List[dict]:
        cur = self._conn.execute(self.query, (self._pos, max_records))
        out = []
        for row in cur.fetchall():
            self._pos = max(self._pos, int(row[0]))
            out.append({c: v for c, v in zip(self.columns, row[1:])})
        return out

    def checkpoint(self) -> int:
        return self._committed

    def commit(self) -> None:
        self._committed = self._pos
        if self.checkpoint_path:
            tmp = self.checkpoint_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"cursor": self._committed}, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.checkpoint_path)


class Recordizer:
    """Maps one raw record onto (record_id, {field: value}) (reference:
    idk Recordizer closures, ingest.go:1710 batchFromSchema).

    fields: {field_name: source_key or None (same name)}; values pass
    through — the Batch handles type-specific encoding (keys, BSI, time)."""

    def __init__(self, id_field: Optional[str] = "id",
                 fields: Optional[Dict[str, Optional[str]]] = None):
        self.id_field = id_field
        self.fields = fields

    def __call__(self, raw: dict) -> Tuple[Any, Dict[str, Any]]:
        rid = raw.get(self.id_field) if self.id_field else None
        if self.fields is None:
            vals = {k: v for k, v in raw.items() if k != self.id_field}
        else:
            vals = {f: raw.get(src or f) for f, src in self.fields.items()}
        return rid, vals


class Ingester:
    """The source->batch->import loop (reference: idk.Main.Run
    ingest.go:255, runIngester:319).

    With id_field=None, record ids are auto-allocated through the ID
    allocator under (index, alloc_key) with offset = the source checkpoint:
    a replayed batch gets the same range (exactly-once)."""

    def __init__(self, api: API, index: str, source: Source,
                 fields: Optional[List[str]] = None,
                 recordizer: Optional[Recordizer] = None,
                 batch_size: int = 4096,
                 id_field: Optional[str] = "id",
                 alloc_key: str = "ingest"):
        self.api = api
        self.index = index
        self.source = source
        self.recordizer = recordizer or Recordizer(id_field=id_field)
        self.batch_size = batch_size
        self.id_field = id_field
        self.alloc_key = alloc_key
        self.session = uuid.uuid4().hex
        idx = api.holder.index(index)
        if idx is None:
            raise APIError(f"index not found: {index}", 404)
        if fields is None:
            fields = [f.name for f in idx.public_fields()]
        self.fields = fields
        # crash injection hook for tests: called after import, before commit
        self._post_import_hook = None
        # Durability: the Batch path writes fragments directly (not through
        # the WAL), so a durable API must checkpoint BEFORE the source
        # offset commits — otherwise a crash after offset-commit loses the
        # batch while the broker thinks it was delivered (reference
        # ordering: idk/ingest.go:1062 commitRecord runs after the
        # transactional import is durable).
        self.checkpoint_after_batch = api.wal is not None

    def run(self, max_batches: Optional[int] = None) -> dict:
        """Drain the source; returns {'records': n, 'batches': b}."""
        n_records = 0
        n_batches = 0
        while max_batches is None or n_batches < max_batches:
            records = self.source.poll(self.batch_size)
            if not records:
                break
            batch = Batch(self.api, self.index, self.fields,
                          size=len(records) + 1)
            if self.id_field is None:
                # auto-id: same (session, checkpoint) -> same range on replay
                ranges = self.api.reserve_ids(
                    self.index, self.alloc_key, self.session,
                    self.source.checkpoint(), len(records))
                ids = list(range(ranges[0].start, ranges[0].end))
            else:
                ids = None
            for ri, raw in enumerate(records):
                rid, vals = self.recordizer(raw)
                if ids is not None:
                    rid = ids[ri]
                if rid is None:
                    continue
                batch.add(rid, **{k: v for k, v in vals.items()
                                  if k in self.fields and v is not None})
            batch.import_batch()
            if self.checkpoint_after_batch:
                self.api.checkpoint()
            if self._post_import_hook is not None:
                self._post_import_hook(n_batches)
            if self.id_field is None:
                self.api.commit_ids(self.index, self.alloc_key, self.session,
                                    self.source.checkpoint(), len(records))
            self.source.commit()
            n_records += len(records)
            n_batches += 1
        return {"records": n_records, "batches": n_batches}
