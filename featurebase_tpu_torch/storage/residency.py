"""Device residency manager: LRU eviction under a byte budget.

Own copy of featurebase_tpu/storage/residency.py (reference rbf/db.go:45,
the RBF page-cache role).  The cached unit is a whole device tensor: a
fragment's (rows, W) mirror (model/fragment.py ``device_tile``) or a plan
executor's stacked leaf (executor/plan.py ``_cached_stack``).  The host
master stays authoritative, so an eviction only drops the owner's reference
and a miss is one upload on next use.

Budget: ``FEATUREBASE_TPU_HBM_BUDGET`` (bytes), else half of the card's
total memory as ``torch.cuda.mem_get_info()`` reports it (read once, at
first use, and only when CUDA is available), else ``8 << 30``.  A single
entry larger than the whole budget is allowed (the query would otherwise be
impossible); everything else is evicted around it.

The budget is held against the bytes registered here, as in the reference.
The CUDA caching allocator keeps freed blocks, so ``mem_get_info()`` does
not fall after an eviction and says nothing about it.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Callable, Optional

_FALLBACK_BUDGET = 8 << 30   # the reference's default, used without CUDA
_card_budget: Optional[int] = None


def default_budget() -> int:
    """Half of the card's total memory (half for data, as the reference's
    default), or ``8 << 30`` when CUDA is not available."""
    global _card_budget
    if _card_budget is None:
        import torch
        if torch.cuda.is_available():
            _card_budget = torch.cuda.mem_get_info()[1] // 2
        else:
            _card_budget = _FALLBACK_BUDGET
    return _card_budget


class DeviceResidency:
    """Thread-safe LRU of device-resident cache entries.

    Entries register with (key, nbytes, evict_fn); evict_fn drops the
    owner's device reference (it must NOT take long-held locks — a query in
    flight keeps its tensors alive through its local references).
    """

    def __init__(self, budget: Optional[int] = None):
        env = os.environ.get("FEATUREBASE_TPU_HBM_BUDGET")
        self.budget = budget if budget is not None else (
            int(env) if env else default_budget())
        self._lock = threading.Lock()
        self._entries: "OrderedDict[object, tuple]" = OrderedDict()
        self.bytes = 0
        self.evictions = 0
        # thrash = an evicted entry re-registered soon after (ping-pong
        # between over-budget working sets)
        self.thrash = 0
        self._recently_evicted: "OrderedDict[object, None]" = OrderedDict()

    def set_budget(self, budget: int):
        with self._lock:
            self.budget = budget
        self._shrink(protect=None)

    def add(self, key, nbytes: int, evict_fn: Callable[[], None]):
        """Register (or refresh) a device-resident entry, then evict LRU
        entries until the budget holds (never the entry just added)."""
        with self._lock:
            if key in self._recently_evicted:
                self._recently_evicted.pop(key, None)
                self.thrash += 1
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[0]
            self._entries[key] = (nbytes, evict_fn)
            self.bytes += nbytes
        self._shrink(protect=key)

    def touch(self, key):
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)

    def remove(self, key):
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.bytes -= old[0]

    def _shrink(self, protect):
        while True:
            with self._lock:
                if self.bytes <= self.budget:
                    return
                victim = None
                for k in self._entries:
                    if k != protect:
                        victim = k
                        break
                if victim is None:
                    return  # only the protected entry remains
                nbytes, evict_fn = self._entries.pop(victim)
                self.bytes -= nbytes
                self.evictions += 1
                self._recently_evicted[victim] = None
                while len(self._recently_evicted) > 256:
                    self._recently_evicted.popitem(last=False)
            evict_fn()  # outside the lock: the owner clears its reference

    def stats(self) -> dict:
        with self._lock:
            return {"bytes": self.bytes, "budget": self.budget,
                    "entries": len(self._entries),
                    "evictions": self.evictions, "thrash": self.thrash,
                    "largest": max((n for n, _ in self._entries.values()),
                                   default=0)}


_global: Optional[DeviceResidency] = None
_global_lock = threading.Lock()


def residency() -> DeviceResidency:
    global _global
    with _global_lock:
        if _global is None:
            _global = DeviceResidency()
        return _global


def reset(budget: Optional[int] = None) -> DeviceResidency:
    """Replace the global manager (tests, and chip_smoke.py's residency
    phase)."""
    global _global
    with _global_lock:
        _global = DeviceResidency(budget)
        return _global
