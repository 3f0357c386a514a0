"""DAX durable storage: writelogger + snapshotter + resource manager.

Own copy of featurebase_tpu/dax/storage.py, in its on-disk layout
(`<dir>/<bucket>/<key>/<version>.log` of JSON lines, fsync'd, read up to a
torn tail; `<version>.snap` written through `.tmp` and `os.replace`), so
that a directory written by either package loads in the other's.  Entries
that are durable together (a roaring shard import's views) go in one
write and one fsync.  Beside the JAX package's, a resource has a holder
(ResourceManager), so that a computer that gave a shard up cannot log a
write that the new holder's load or snapshot misses.

Mirrors the reference's disaggregated storage services (reference:
dax/writelogger/writelogger.go:22,46 — append-only per (bucket, key,
version) log files, fsync'd; dax/snapshotter/snapshotter.go:24,44 —
versioned snapshot blobs; dax/storage/storage.go:19 ResourceManager —
pairs them, snapshot = write new version + truncate log).

Both are filesystem-backed; in a cloud deployment the directory is a
shared/durable volume (the reference points them at object storage).
Computers use them as libraries over that shared mount — the service
boundary of the reference collapses to a path, which is the idiomatic
single-cluster TPU deployment.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple


def _safe(name: str) -> str:
    return name.replace("/", "__")


class Writelogger:
    """Append-only versioned logs (reference: writelogger.go:22)."""

    def __init__(self, directory: str):
        self.dir = directory
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _path(self, bucket: str, key: str, version: int) -> str:
        d = os.path.join(self.dir, _safe(bucket), _safe(key))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{version}.log")

    def append(self, bucket: str, key: str, version: int, entry: dict):
        self.append_many(bucket, key, version, [entry])

    def append_many(self, bucket: str, key: str, version: int,
                    entries: List[dict]):
        """Append entries in order, durable together: one write and one
        fsync (a roaring shard import's views)."""
        data = "".join(json.dumps(e, separators=(",", ":")) + "\n"
                       for e in entries)
        with self._lock:
            with open(self._path(bucket, key, version), "a") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())

    def read(self, bucket: str, key: str, version: int) -> List[dict]:
        path = self._path(bucket, key, version)
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        break  # torn tail write: stop at corruption
        return out

    def versions(self, bucket: str, key: str) -> List[int]:
        d = os.path.join(self.dir, _safe(bucket), _safe(key))
        if not os.path.isdir(d):
            return []
        return sorted(int(f[:-4]) for f in os.listdir(d)
                      if f.endswith(".log"))

    def delete_before(self, bucket: str, key: str, version: int):
        for v in self.versions(bucket, key):
            if v < version:
                os.unlink(self._path(bucket, key, v))


class Snapshotter:
    """Versioned snapshot blobs (reference: snapshotter.go:24)."""

    def __init__(self, directory: str):
        self.dir = directory
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _path(self, bucket: str, key: str, version: int) -> str:
        d = os.path.join(self.dir, _safe(bucket), _safe(key))
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{version}.snap")

    def write(self, bucket: str, key: str, version: int, data: bytes):
        path = self._path(bucket, key, version)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)

    def read(self, bucket: str, key: str,
             version: int) -> Optional[bytes]:
        path = self._path(bucket, key, version)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            return fh.read()

    def latest_version(self, bucket: str, key: str) -> Optional[int]:
        d = os.path.join(self.dir, _safe(bucket), _safe(key))
        if not os.path.isdir(d):
            return None
        vs = [int(f[:-5]) for f in os.listdir(d) if f.endswith(".snap")]
        return max(vs) if vs else None


class NotHeld(Exception):
    """An append in the name of a computer that does not hold the
    resource."""


class ResourceManager:
    """One durable resource = snapshot + live log at a version (reference:
    dax/storage/storage.go:19).

    Writes append to log version V; snapshot() writes snapshot V+1 from the
    caller's serializer, bumps the live log to V+1, and deletes old logs.
    Load = read latest snapshot version V, apply, then replay log V.

    A resource may have a holder, the computer that loaded it: an append
    in another's name is refused, a load in a computer's name makes it
    the holder before it reads, and a snapshot in a computer's name is cut
    only while it holds the resource.  A load and a snapshot of one
    resource never overlap.
    """

    def __init__(self, wl: Writelogger, snap: Snapshotter):
        self.wl = wl
        self.snap = snap
        self._lock = threading.Lock()
        self._versions: Dict[Tuple[str, str], int] = {}
        self._holders: Dict[Tuple[str, str], Optional[str]] = {}
        self._key_locks: Dict[Tuple[str, str], threading.Lock] = {}

    def _version(self, bucket: str, key: str) -> int:
        k = (bucket, key)
        v = self._versions.get(k)
        if v is None:
            sv = self.snap.latest_version(bucket, key)
            lv = self.wl.versions(bucket, key)
            v = max([sv if sv is not None else 0] + lv)
            self._versions[k] = v
        return v

    def _key_lock(self, bucket: str, key: str) -> threading.Lock:
        with self._lock:
            return self._key_locks.setdefault((bucket, key),
                                              threading.Lock())

    def release(self, bucket: str, key: str, holder: str):
        """`holder` gives the resource up: nobody's appends are taken
        until the next load in a computer's name."""
        with self._lock:
            if self._holders.get((bucket, key)) == holder:
                self._holders[(bucket, key)] = None

    def holds(self, bucket: str, key: str, holder: str) -> bool:
        with self._lock:
            return self._holders.get((bucket, key)) == holder

    def append(self, bucket: str, key: str, entry: dict,
               holder: Optional[str] = None):
        self.append_many(bucket, key, [entry], holder=holder)

    def append_many(self, bucket: str, key: str, entries: List[dict],
                    holder: Optional[str] = None):
        """Append to the live log; with `holder`, only while it holds the
        resource (NotHeld otherwise, and nothing is written)."""
        with self._lock:
            if holder is not None and \
                    self._holders.get((bucket, key)) != holder:
                raise NotHeld(f"{bucket}/{key} is not held by {holder}")
            v = self._version(bucket, key)
            self.wl.append_many(bucket, key, v, entries)

    def load(self, bucket: str, key: str,
             apply_snapshot: Callable[[bytes], None],
             apply_entry: Callable[[dict], None],
             holder: Optional[str] = None) -> bool:
        """Restore a resource: latest snapshot then log replay (reference:
        api_directive.go:559 loadShard), `holder` holding it from before
        the read.  Returns True if anything loaded."""
        with self._key_lock(bucket, key):
            with self._lock:
                if holder is not None:
                    self._holders[(bucket, key)] = holder
                self._version(bucket, key)
            found = False
            sv = self.snap.latest_version(bucket, key)
            if sv is not None:
                data = self.snap.read(bucket, key, sv)
                if data:
                    apply_snapshot(data)
                    found = True
            for lv in self.wl.versions(bucket, key):
                if sv is not None and lv < sv:
                    continue
                for entry in self.wl.read(bucket, key, lv):
                    apply_entry(entry)
                    found = True
            return found

    def snapshot(self, bucket: str, key: str, serialize: Callable[[], bytes],
                 holder: Optional[str] = None,
                 carry: Optional[Callable[[], List[dict]]] = None) -> bool:
        """Cut a snapshot and truncate the log (reference: snapshot = write
        new version + truncate log, storage.go:19); `carry`'s entries, if
        given, start the new log.  With `holder`, only while it holds the
        resource; returns whether the snapshot was cut."""
        with self._key_lock(bucket, key):
            with self._lock:
                if holder is not None and \
                        self._holders.get((bucket, key)) != holder:
                    return False
                nv = self._version(bucket, key) + 1
                self._versions[(bucket, key)] = nv
            self.snap.write(bucket, key, nv, serialize())
            entries = carry() if carry is not None else []
            if entries:
                self.wl.append_many(bucket, key, nv, entries)
            self.wl.delete_before(bucket, key, nv)
            return True
