"""Write-ahead log for mutations.

The durability role of the reference's RBF WAL (reference: rbf/db.go:163
openWAL, 264 checkpoint — every write Tx appends WAL pages, checkpoint folds
them into the main file) and of DAX's Writelogger (reference:
dax/writelogger/writelogger.go:22 append-only per-resource logs replayed on
shard load).  Here: one JSONL log per holder; every logical mutation is an
entry; recovery = load last snapshot + replay the log; snapshot() truncates.

Entries are logical ops (not page images) so the log is compact and
replayable through the public API:
  {"op": "set", "i": index, "f": field, "r": row, "c": col, "ts": ...}
  {"op": "clear"|"setval"|"clearval"|"clearrow"|"store"|"delete_cols"...}
  {"op": "import", ...base64 roaring payloads...}
  {"op": "schema", ...}

Own copy of featurebase_tpu/storage/wal.py.
"""
from __future__ import annotations

import base64
import json
import os
import threading
from typing import Callable


class WAL:
    """Group-commit WAL: concurrent appends coalesce into one write+fsync.

    With fsync on, an append blocks until its entry is durable, but all
    appends that arrive while a flush is in progress are committed by the
    NEXT single fsync — one disk sync per *group*, not per entry
    (reference: rbf WAL batches a Tx's pages into one sync, rbf/db.go:264;
    group commit is the classic WAL throughput fix).  With fsync off,
    appends buffer and a flush happens on each group boundary without the
    sync."""

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "ab")
        self._buf: list = []
        self._seq = 0          # last enqueued entry
        self._durable = 0      # last flushed (+fsynced) entry
        self._flushed_cv = threading.Condition(self._lock)
        self.sync_count = 0    # fsyncs issued (tests assert grouping)

    def append(self, entry: dict):
        data = (json.dumps(entry, separators=(",", ":")) + "\n").encode()
        with self._lock:
            self._buf.append(data)
            self._seq += 1
            my_seq = self._seq
        # group commit: whoever grabs the flush lock writes everything
        # buffered so far; everyone else just waits for durability
        while True:
            with self._lock:
                if self._durable >= my_seq:
                    return
            if self._flush_lock.acquire(blocking=False):
                try:
                    self._flush_group()
                finally:
                    self._flush_lock.release()
            else:
                with self._flushed_cv:
                    if self._durable < my_seq:
                        self._flushed_cv.wait(timeout=0.05)

    def _flush_group(self):
        with self._lock:
            buf, self._buf = self._buf, []
            upto = self._seq - len(self._buf)
        if buf:
            self._fh.write(b"".join(buf))
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
                self.sync_count += 1
        with self._flushed_cv:
            self._durable = max(self._durable, upto)
            self._flushed_cv.notify_all()

    def truncate(self):
        """Called after a successful snapshot (reference rbf checkpoint /
        DAX snapshot+log-truncate, dax/storage/storage.go:19)."""
        with self._flush_lock:
            with self._lock:
                self._buf = []
                self._durable = self._seq
                self._fh.close()
                self._fh = open(self.path, "wb")

    def close(self):
        with self._flush_lock:
            self._flush_group()
            with self._lock:
                self._fh.close()

    def replay(self, apply: Callable[[dict], None]):
        """Re-apply every entry (crash recovery)."""
        if not os.path.exists(self.path):
            return 0
        n = 0
        with open(self.path, "rb") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail write — stop at last good entry
                apply(entry)
                n += 1
        return n


def encode_bytes(b: bytes) -> str:
    return base64.b64encode(b).decode()


def decode_bytes(s: str) -> bytes:
    return base64.b64decode(s)
