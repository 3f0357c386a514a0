"""Host-DRAM residency manager: fragment host masters under a byte budget.

Own copy of featurebase_tpu/storage/hostmem.py.  The reference's storage
tier is disk-backed and paged (RBF mmaps 8KB pages, reference:
rbf/db.go:45), so a dataset larger than DRAM still runs.  Here every
fragment's host words register with this manager, and when the total
exceeds the host budget the least-recently-used fragments spill to disk
(one .npy per fragment in a spill dir) and reload on their next access
(model/fragment.py).  A reload leaves the fragment's generation alone, so
its device mirror and the plan executor's cached leaves stay valid.

Budget: FEATUREBASE_TPU_HOST_BUDGET (bytes), by default half of system RAM.
Spill root: FEATUREBASE_TPU_SPILL_DIR, else a per-process temp dir.  The
device-side counterpart is storage/residency.py (device mirrors); this is
the DRAM tier underneath it.
"""
from __future__ import annotations

import os
import tempfile
import threading
from collections import OrderedDict
from typing import Callable, Optional


def _default_budget() -> int:
    env = os.environ.get("FEATUREBASE_TPU_HOST_BUDGET")
    if env:
        return int(env)
    try:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
        return max(total // 2, 1 << 30)
    except (ValueError, OSError):
        return 8 << 30


class HostResidency:
    """Thread-safe LRU of host-resident fragment arrays.

    Same contract as DeviceResidency: entries register with (key, nbytes,
    offload_fn); offload_fn persists the owner's array to spill and drops
    the in-memory reference (it may take the owner's lock — eviction of a
    fragment mid-write simply waits for the write to finish)."""

    def __init__(self, budget: Optional[int] = None):
        self.budget = budget if budget is not None else _default_budget()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[object, tuple]" = OrderedDict()
        # the key last moved to the end: touching it again takes no lock
        # (readers of a fragment touch it once a host word access)
        self._last = None
        self.bytes = 0
        self.evictions = 0
        self.reloads = 0
        self._spill_dir: Optional[str] = None
        # GC-safe removal queue: fragment finalizers call remove() and a
        # collection can fire DURING an allocation made while this thread
        # holds _lock (inside add/_shrink) — a blocking acquire there
        # self-deadlocks, so removals enqueue lock-free (deque.append is
        # atomic) and drain at the next locked entry point.
        import collections
        self._removals: "collections.deque" = collections.deque()

    def spill_dir(self) -> str:
        with self._lock:
            if self._spill_dir is None:
                base = os.environ.get("FEATUREBASE_TPU_SPILL_DIR")
                if base:
                    os.makedirs(base, exist_ok=True)
                    self._spill_dir = base
                else:
                    self._spill_dir = tempfile.mkdtemp(
                        prefix="featurebase_tpu_torch_spill_")
            return self._spill_dir

    def set_budget(self, budget: int):
        with self._lock:
            self.budget = budget
        self._shrink(protect=None)

    def _drain_locked(self):
        """Apply queued removals; caller holds self._lock."""
        while True:
            try:
                key = self._removals.popleft()
            except IndexError:
                return
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[0]

    def add(self, key, nbytes: int, offload_fn: Callable[[], None]):
        with self._lock:
            self._drain_locked()
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[0]
            self._entries[key] = (nbytes, offload_fn)
            self._last = key
            self.bytes += nbytes
        self._shrink(protect=key)

    def touch(self, key):
        if self._last == key:    # the most recent already, or gone
            return
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self._last = key

    def remove(self, key):
        """Safe from any context, including GC finalizers that interrupt
        a thread currently holding the manager lock."""
        self._removals.append(key)

    def note_reload(self):
        with self._lock:
            self.reloads += 1

    def _shrink(self, protect):
        # iteration guard: a busy fragment re-registers itself instead of
        # spilling (lock-free eviction), so bound the pass to avoid
        # spinning when every entry is briefly busy
        with self._lock:
            max_iters = 2 * len(self._entries) + 8
        for _ in range(max_iters):
            with self._lock:
                self._drain_locked()
                if self.bytes <= self.budget:
                    return
                victim = None
                for k in self._entries:
                    if k != protect:
                        victim = k
                        break
                if victim is None:
                    return
                nbytes, offload_fn = self._entries.pop(victim)
                self.bytes -= nbytes
                self.evictions += 1
            offload_fn()  # outside the manager lock

    def stats(self) -> dict:
        with self._lock:
            self._drain_locked()
            return {"bytes": self.bytes, "budget": self.budget,
                    "entries": len(self._entries),
                    "evictions": self.evictions, "reloads": self.reloads}


_global: Optional[HostResidency] = None
_global_lock = threading.Lock()


def hostmem() -> HostResidency:
    global _global
    g = _global
    if g is not None:
        return g
    with _global_lock:
        if _global is None:
            _global = HostResidency()
        return _global


def reset(budget: Optional[int] = None) -> HostResidency:
    """Replace the global manager (tests)."""
    global _global
    with _global_lock:
        _global = HostResidency(budget)
        return _global
