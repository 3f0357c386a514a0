"""Replicated, ordered schema-operation log (term-based leader consensus).

Own copy of featurebase_tpu/cluster/schemalog.py.  The reference keeps its
schema in etcd, whose raft log gives every node one ordered view of
CreateIndex/CreateField/Delete (disco/disco.go:92 Schemator;
etcd/embed.go:31).  Here:

- One deterministic reachable leader per node view (the lowest node id that
  answers /health) takes every schema op.
- Terms: every committed entry carries a monotonic leader term.  Before a
  commit the leader runs a quorum round (API._ensure_schema_term): it reads
  every reachable peer's (term, applied, suffix), catches up on entries it
  missed, and when its term is no longer the newest establishes
  max_seen + 1 by a majority's vote (peers accept only newer terms).  A
  leader partitioned away while a majority moved on therefore either
  catches up and commits after them under a fresh term, or fails its
  quorum cleanly.  Followers refuse entries of a term older than the
  newest they accepted.
- The leader commits only with a reachable majority: it applies locally
  (validating, so a user error reaches the proposer before anything is
  logged), appends at the next index with its term and broadcasts the
  entry synchronously.  Followers apply strictly in order; a gap fetches
  the suffix from the entry's origin (``/internal/schema/log?from=N``).
- Durability: every appended or received entry is a "schema_log" WAL
  record and every accepted term a "schema_term" one (storage/wal.py), so
  a whole-cluster restart resumes the log (the schema's content replays
  from its own per-op records).

A gap that remains: two proposers whose term rounds interleave within one
commit window are ordered only by the deterministic leader routing, not by
a log-match proof; follower logs still cannot diverge (in-order
application), but such a stale leader's own local apply would need a
raft-style rollback to undo.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional


class SchemaLog:
    def __init__(self):
        self._lock = threading.Lock()
        self.entries: List[dict] = []  # [{"idx": i, "term": t, "op": {}}]
        self.applied = 0               # highest contiguously applied idx
        self.term = 0                  # newest term seen/accepted
        self.term_leader: Optional[str] = None  # node id that owns .term

    # -- terms ---------------------------------------------------------------

    def accept_term(self, term: int, leader: str) -> bool:
        """Vote for a leader's term: accept only strictly newer terms
        (one vote per term — the raft 'votedFor' rule collapsed to the
        single-round lease this log uses)."""
        with self._lock:
            if term <= self.term:
                return leader == self.term_leader and term == self.term
            self.term = term
            self.term_leader = leader
            return True

    def observe_term(self, term: int, leader: Optional[str] = None):
        """Adopt a newer term seen on a committed entry."""
        with self._lock:
            if term > self.term:
                self.term = term
                self.term_leader = leader

    def holds_term(self, leader: str) -> bool:
        with self._lock:
            return self.term_leader == leader

    # -- log -----------------------------------------------------------------

    def append(self, op: dict, term: Optional[int] = None) -> dict:
        """Leader-side commit: next index, recorded as applied."""
        with self._lock:
            entry = {"idx": self.applied + 1,
                     "term": self.term if term is None else term,
                     "op": op}
            self.entries.append(entry)
            self.applied = entry["idx"]
            return entry

    def suffix(self, from_idx: int) -> List[dict]:
        """Entries with idx > from_idx (catch-up payload)."""
        with self._lock:
            return [e for e in self.entries if e["idx"] > from_idx]

    def receive(self, entry: dict,
                fetch: Callable[[int], List[dict]]) -> List[dict]:
        """Follower-side: returns the ordered entries to apply now.
        Duplicates/stale indexes return []; entries from a term older
        than the newest accepted are rejected (stale-leader fencing); a
        gap pulls the missing suffix through `fetch(applied)` (which must
        include `entry`'s index)."""
        with self._lock:
            if entry.get("term", 0) < self.term:
                return []  # stale leader: refuse its commit
            if entry["idx"] <= self.applied:
                return []
            if entry["idx"] == self.applied + 1:
                todo = [entry]
            else:
                got = sorted((e for e in fetch(self.applied)
                              if e["idx"] > self.applied),
                             key=lambda e: e["idx"])
                by_idx: Dict[int, dict] = {e["idx"]: e for e in got}
                by_idx.setdefault(entry["idx"], entry)
                todo = []
                nxt = self.applied + 1
                while nxt in by_idx:
                    todo.append(by_idx[nxt])
                    nxt += 1
            for e in todo:
                self.entries.append(e)
                if e.get("term", 0) > self.term:
                    self.term = e["term"]
                    self.term_leader = None
            if todo:
                self.applied = todo[-1]["idx"]
            return todo

    def install(self, entries: List[dict], applied: int):
        """Replace local state from a peer's log (join / heal pull); only
        ever moves forward.  Returns the entries that were new (to apply,
        idempotently)."""
        with self._lock:
            if applied <= self.applied:
                return []
            fresh = sorted((e for e in entries if e["idx"] > self.applied),
                           key=lambda e: e["idx"])
            self.entries.extend(fresh)
            self.applied = applied
            for e in fresh:
                if e.get("term", 0) > self.term:
                    self.term = e["term"]
                    self.term_leader = None
            return fresh

    def restore_entry(self, entry: dict):
        """WAL-replay rebuild: re-install one persisted entry (idempotent,
        in WAL order; does NOT apply the op — schema content replays from
        its own per-op WAL records)."""
        with self._lock:
            if entry["idx"] <= self.applied:
                return
            self.entries.append(entry)
            self.applied = entry["idx"]
            if entry.get("term", 0) > self.term:
                self.term = entry["term"]
                self.term_leader = None

    def restore_term(self, term: int, leader: Optional[str]):
        with self._lock:
            if term >= self.term:
                self.term = term
                self.term_leader = leader

    def to_json(self) -> dict:
        with self._lock:
            return {"entries": list(self.entries), "applied": self.applied,
                    "term": self.term}
