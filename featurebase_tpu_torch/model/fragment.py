"""Fragment: one dense bitmap per (field, view, shard), host master only.

Own copy of featurebase_tpu/model/fragment.py trimmed to the host master:
row-sparse numpy words (only rows that exist are materialized), the seqlock
generation that keys the plan executor's device caches, and the MVCC row
overlay that serves pinned snapshot reads (model/snapshot.py).  The device
mirror and host spill of the JAX package are not part of the port yet: the
plan executor (executor/plan.py) uploads stacked leaves from ``host_row``.

Layout per row: SHARD_WIDTH bits as (WORDS_PER_ROW,) uint32 little-endian
words (see core/consts.py).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List

import numpy as np

from featurebase_tpu_torch.core.consts import SHARD_WIDTH, WORDS_PER_ROW

_INIT_CAP = 4


class Fragment:
    """Dense bitmap fragment for (index, field, view, shard)."""

    def __init__(self, index: str, field: str, view: str, shard: int):
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self._lock = threading.RLock()
        self._words = np.zeros((_INIT_CAP, WORDS_PER_ROW), dtype=np.uint32)
        self._row_of_slot: List[int] = []
        self._slot_of_row: Dict[int, int] = {}
        # Seqlock generation: odd while host words mutate, even otherwise
        # (both transitions under self._lock).
        self.generation = 0
        # MVCC overlay: row -> [(even-gen tag, words copy)] ascending
        self._overlay: Dict[int, list] = {}

    @contextmanager
    def _mutating(self):
        """Seqlock write section; caller must hold self._lock."""
        self.generation += 1
        try:
            yield
        finally:
            self.generation += 1

    def _cow(self, slot: int):
        """Preserve a row about to mutate for active snapshot pins
        (first-touch copy-on-write; caller holds self._lock inside the
        _mutating window, before the row's words change).  A pin still
        mid-capture with no entry for this fragment is preserved for
        conservatively."""
        from featurebase_tpu_torch.model.snapshot import active_pins
        pins = active_pins(self.index)
        if not pins:
            if self._overlay:
                self._overlay.clear()
            return
        row = self._row_of_slot[slot]
        e = self.generation & ~1  # committed generation being overwritten
        tags = self._overlay.get(row)
        need = False
        for pin in pins:
            p = pin.gen_for(self.field, self.view, self.shard)
            if p is None:
                if pin.complete:
                    continue  # fragment absent at pin (reads as empty)
                p = e  # capture in flight: assume it will pin <= e
            if p > e:
                continue  # pin is newer than the state being overwritten
            if tags is not None and any(p <= t for t, _ in tags):
                continue  # an existing copy already serves this pin
            need = True
            break
        if need:
            self._overlay.setdefault(row, []).append(
                (e, self._words[slot].copy()))

    def _pinned_row(self, pin, row: int) -> np.ndarray:
        """Row words as of `pin`'s snapshot ((W,) uint32; callers must not
        mutate).  A live read is verified against the overlay after copying."""
        p = pin.gen_for(self.field, self.view, self.shard)
        if p is None:
            return np.zeros(WORDS_PER_ROW, dtype=np.uint32)

        def overlay_copy():
            for t, wcopy in self._overlay.get(row, ()):
                if t >= p:
                    return wcopy
            return None

        pre = overlay_copy()
        if pre is not None:
            return pre
        slot = self._slot_of_row.get(row)
        if slot is None:
            return np.zeros(WORDS_PER_ROW, dtype=np.uint32)
        live = self._words[slot].copy()
        post = overlay_copy()  # appeared mid-copy -> live may be torn
        return post if post is not None else live

    def pin_current(self, pin) -> bool:
        """True when the fragment is unchanged since `pin`."""
        return pin.gen_for(self.field, self.view, self.shard) == \
            self.generation

    # -- host-side row management ------------------------------------------

    @property
    def num_rows(self) -> int:
        return len(self._row_of_slot)

    def row_ids(self) -> np.ndarray:
        """Sorted row ids present (may include all-zero rows after clears)."""
        return np.array(sorted(self._slot_of_row), dtype=np.uint64)

    def has_row(self, row: int) -> bool:
        return row in self._slot_of_row

    def _ensure_slot(self, row: int) -> int:
        slot = self._slot_of_row.get(row)
        if slot is not None:
            return slot
        slot = len(self._row_of_slot)
        if slot >= self._words.shape[0]:
            new_cap = max(2 * self._words.shape[0], slot + 1)
            grown = np.zeros((new_cap, WORDS_PER_ROW), dtype=np.uint32)
            grown[: self._words.shape[0]] = self._words
            self._words = grown
        self._row_of_slot.append(row)
        self._slot_of_row[row] = slot
        return slot

    def host_row(self, row: int) -> np.ndarray:
        """Host words for a row ((W,) uint32); zeros if absent.  Under an
        active snapshot pin, serves the row as of the pin."""
        from featurebase_tpu_torch.model.snapshot import current_pin
        pin = current_pin()
        if pin is not None:
            return self._pinned_row(pin, row)
        slot = self._slot_of_row.get(row)
        if slot is None:
            return np.zeros(WORDS_PER_ROW, dtype=np.uint32)
        return self._words[slot]

    # -- bit mutation (reference fragment.setBit:337 / clearBit) -----------

    def set_bit(self, row: int, col: int) -> bool:
        """Set bit; returns True if it changed. col is column-within-shard."""
        col %= SHARD_WIDTH
        with self._lock:
            slot = self._ensure_slot(row)
            w, b = col >> 5, np.uint32(1 << (col & 31))
            old = self._words[slot, w]
            if old & b:
                return False
            with self._mutating():
                self._cow(slot)
                self._words[slot, w] = old | b
            return True

    def clear_bit(self, row: int, col: int) -> bool:
        col %= SHARD_WIDTH
        with self._lock:
            slot = self._slot_of_row.get(row)
            if slot is None:
                return False
            w, b = col >> 5, np.uint32(1 << (col & 31))
            old = self._words[slot, w]
            if not (old & b):
                return False
            with self._mutating():
                self._cow(slot)
                self._words[slot, w] = old & ~b
            return True

    def get_bit(self, row: int, col: int) -> bool:
        col %= SHARD_WIDTH
        from featurebase_tpu_torch.model.snapshot import current_pin
        pin = current_pin()
        if pin is not None:
            w = self._pinned_row(pin, row)
            return bool((w[col >> 5] >> (col & 31)) & 1)
        slot = self._slot_of_row.get(row)
        if slot is None:
            return False
        return bool((self._words[slot, col >> 5] >> (col & 31)) & 1)

    # -- bulk ops (reference fragment.bulkImport:1498, importPositions:1731) -

    def import_bits(self, rows: np.ndarray, cols: np.ndarray,
                    clear: bool = False):
        """Bulk set bits given parallel (row, col-in-shard) arrays."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64) % SHARD_WIDTH
        with self._lock:
            order = np.argsort(rows, kind="stable")
            rows, cols = rows[order], cols[order]
            uniq, starts = np.unique(rows, return_index=True)
            bounds = np.append(starts, rows.size)
            with self._mutating():
                for i, r in enumerate(uniq):
                    c = cols[bounds[i]:bounds[i + 1]]
                    slot = self._ensure_slot(int(r))
                    self._cow(slot)
                    tgt = self._words[slot]
                    vals = np.uint32(1) << (c & 31).astype(np.uint32)
                    if clear:
                        mask = np.zeros(WORDS_PER_ROW, dtype=np.uint32)
                        np.bitwise_or.at(mask, c >> 5, vals)
                        np.bitwise_and(tgt, ~mask, out=tgt)
                    else:
                        np.bitwise_or.at(tgt, c >> 5, vals)

    def merge_rows_delta(self, rows, delta: np.ndarray):
        """OR a (R, W) delta tile into R rows in ONE lock/seqlock window
        (the BSI bulk-import path; reference fragment.importValue:1947)."""
        with self._lock:
            slots = [self._ensure_slot(int(r)) for r in rows]
            with self._mutating():
                for slot in slots:
                    self._cow(slot)
                w = self._words
                for slot, d in zip(slots, delta):
                    np.bitwise_or(w[slot], d, out=w[slot])

    def clear_columns(self, col_mask: np.ndarray):
        """ANDNOT a dense column mask out of every row."""
        with self._lock:
            n = self.num_rows
            if n == 0:
                return
            with self._mutating():
                for slot in range(n):
                    self._cow(slot)
                np.bitwise_and(self._words[:n], ~col_mask[None, :],
                               out=self._words[:n])

    # -- persistence --------------------------------------------------------

    @classmethod
    def from_npz_dict(cls, index, field, view, shard, d) -> "Fragment":
        f = cls(index, field, view, shard)
        rows = d["rows"]
        n = len(rows)
        f._words = np.zeros((max(_INIT_CAP, n), WORDS_PER_ROW),
                            dtype=np.uint32)
        f._words[:n] = d["words"]
        f._row_of_slot = [int(r) for r in rows]
        f._slot_of_row = {int(r): i for i, r in enumerate(rows)}
        return f
