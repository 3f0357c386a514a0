"""Active-query tracker + query-history ring + long-query log.

Mirrors the reference's tracker (reference: tracker.go:9 activeQueryTracker,
query history ring; api.go:2425 ActiveQueries, :2432 PastQueries; exposed at
/queries and /query-history http_handler.go; LongQueryTime logging
api.go:2089).

Own copy of featurebase_tpu/utils/tracker.py.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional


class QueryTracker:
    def __init__(self, history_size: int = 100,
                 long_query_time: Optional[float] = None, logger=None):
        self._lock = threading.Lock()
        self._active: dict = {}
        self._next_id = 0
        self._history = deque(maxlen=history_size)
        self.long_query_time = long_query_time
        self.logger = logger

    def start(self, index: str, query: str, node_id: str = "") -> int:
        with self._lock:
            self._next_id += 1
            qid = self._next_id
            self._active[qid] = {"index": index, "PQL": query,
                                 "node": node_id, "start": time.time(),
                                 "cancel": threading.Event()}
            return qid

    def cancel(self, qid: int) -> bool:
        """Request cooperative cancellation of an active query (reference:
        api.go ActiveQueries + ctx cancellation)."""
        with self._lock:
            rec = self._active.get(qid)
        if rec is None:
            return False
        rec["cancel"].set()
        return True

    def cancel_event(self, qid: int):
        with self._lock:
            rec = self._active.get(qid)
        return rec["cancel"] if rec is not None else None

    def finish(self, qid: int, error: Optional[str] = None):
        with self._lock:
            rec = self._active.pop(qid, None)
        if rec is None:
            return
        rec.pop("cancel", None)
        rec["runtime"] = time.time() - rec["start"]
        rec["error"] = error
        with self._lock:
            self._history.appendleft(rec)
        if self.long_query_time is not None and \
                rec["runtime"] >= self.long_query_time and \
                self.logger is not None:
            self.logger.warn("long query (%.3fs): %s on %s",
                             rec["runtime"], rec["PQL"], rec["index"])

    def active(self) -> List[dict]:
        now = time.time()
        with self._lock:
            return [{"id": qid, "index": r["index"], "PQL": r["PQL"],
                     "node": r["node"], "age": now - r["start"]}
                    for qid, r in self._active.items()]

    def past(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._history]


class Transaction:
    """Exclusive/shared transaction record (reference: transaction.go,
    api.go:2364 StartTransaction)."""

    __slots__ = ("id", "timeout", "exclusive", "active", "created",
                 "deadline", "stats")

    def __init__(self, id: str, timeout: float, exclusive: bool):
        self.id = id
        self.timeout = timeout
        self.exclusive = exclusive
        self.active = False
        self.created = time.time()
        self.deadline = self.created + timeout

    def to_json(self) -> dict:
        return {"id": self.id, "timeout": f"{self.timeout}s",
                "exclusive": self.exclusive, "active": self.active,
                "deadline": self.deadline}


class TransactionStore:
    """In-memory transaction manager (reference: transaction.go:320
    InMemTransactionStore semantics: one exclusive transaction blocks new
    ones; transactions expire at their deadline)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._txs: dict = {}

    def _reap(self):
        now = time.time()
        for tid in [t for t, tx in self._txs.items() if tx.deadline < now]:
            del self._txs[tid]

    def start(self, id: str, timeout: float, exclusive: bool) -> Transaction:
        with self._lock:
            self._reap()
            if id in self._txs:
                raise ValueError(f"transaction already exists: {id}")
            excl_active = any(t.exclusive and t.active
                              for t in self._txs.values())
            tx = Transaction(id, timeout, exclusive)
            if exclusive:
                # becomes active when it is the only transaction
                tx.active = len(self._txs) == 0
            else:
                tx.active = not excl_active
            self._txs[id] = tx
            return tx

    def finish(self, id: str) -> Transaction:
        with self._lock:
            self._reap()
            tx = self._txs.pop(id, None)
            if tx is None:
                raise KeyError(id)
            # promote a waiting exclusive transaction if it's now alone
            if len(self._txs) == 1:
                only = next(iter(self._txs.values()))
                if only.exclusive:
                    only.active = True
            return tx

    def get(self, id: str) -> Transaction:
        with self._lock:
            self._reap()
            tx = self._txs.get(id)
            if tx is None:
                raise KeyError(id)
            return tx

    def list(self) -> dict:
        with self._lock:
            self._reap()
            return {t: tx.to_json() for t, tx in self._txs.items()}

    def active_exclusive(self) -> Optional[Transaction]:
        """The currently active exclusive transaction, if any (its holder
        has sole write access; reference: transaction.go exclusive
        semantics used by backups)."""
        with self._lock:
            self._reap()
            for tx in self._txs.values():
                if tx.exclusive and tx.active:
                    return tx
            return None
