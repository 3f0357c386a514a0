"""Shared/exclusive gate for an index's writers (own copy of
featurebase_tpu/utils/rwlock.py).

The reference gets snapshot isolation from RBF's MVCC page maps: one
writer, many readers, each read Tx pinned to a page-map snapshot
(reference: rbf/db.go:45 page cache, txfactory.go:84 Qcx).  Dense tiles
have no page maps; pinned reads go through the row overlays of
model/snapshot.py and never take this gate.  Writers hold it SHARED (many
concurrent writers: per-fragment locks serialize the actual mutation); a
caller that must briefly freeze every writer holds it EXCLUSIVE.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager


class ShardedGate:
    """Counting shared/exclusive lock, exclusive-preferring."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = 0
        self._exclusive = False
        self._excl_waiting = 0

    @contextmanager
    def shared(self):
        with self._cond:
            while self._exclusive or self._excl_waiting:
                self._cond.wait()
            self._shared += 1
        try:
            yield
        finally:
            with self._cond:
                self._shared -= 1
                if self._shared == 0:
                    self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        with self._cond:
            self._excl_waiting += 1
            while self._exclusive or self._shared:
                self._cond.wait()
            self._excl_waiting -= 1
            self._exclusive = True
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()
