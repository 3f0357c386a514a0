"""Fragment: one dense bitmap per (field, view, shard).

Own copy of featurebase_tpu/model/fragment.py: the host master (row-sparse
numpy words, only rows that exist are materialized), the seqlock generation
that keys the plan executor's device caches (each move bumps the write
clock, model/clock.py), the MVCC row overlay that
serves pinned snapshot reads (model/snapshot.py), and the device mirror of
all rows (``device_tile``), kept in step through dirty-slot tracking and
registered with the residency LRU (storage/residency.py), and the host
tier: the host words register with the host-DRAM budget
(storage/hostmem.py), which may spill them to disk; they reload on their
next access, with the generation unchanged (a reload is not a write).

Layout per row: SHARD_WIDTH bits as (WORDS_PER_ROW,) uint32 little-endian
words (see core/consts.py).
"""
from __future__ import annotations

import functools
import itertools
import os
import threading
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import SHARD_WIDTH, WORDS_PER_ROW
from featurebase_tpu_torch.model.clock import Clock
from featurebase_tpu_torch.storage.hostmem import hostmem
from featurebase_tpu_torch.utils.tracing import TRACER

_INIT_CAP = 4

# Each fragment's seqlock generation starts at its own base, drawn from one
# process-wide counter, so no two fragments ever show the same generation.
# The device caches key their entries by (name, generation) tuples: a field
# deleted and created again under the same name, with the same number of
# writes, must not meet the old field's entries.  2^32 writes to one
# fragment stay below the next base.
_GENERATION_BASES = itertools.count(1)
_GENERATION_SPAN = 1 << 32


def _fresh_generation() -> int:
    return next(_GENERATION_BASES) * _GENERATION_SPAN


def _drop_host_entry(key):
    hostmem().remove(key)


def _unlink_spill(path):
    try:
        os.unlink(path)
    except OSError:
        pass


def _canonical(device) -> torch.device:
    """`device` with its index, so the mirror's device compares equal to
    the one each caller names ("cuda" and "cuda:0")."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """(R, W) uint32 host rows -> an int32 copy on `device`, through pinned
    host memory on a GPU (as PlanExecutor._put_lazy uploads).  The span
    storage.mirror_upload."""
    with TRACER.span("storage.mirror_upload"):
        src = torch.from_numpy(np.ascontiguousarray(host).view(np.int32))
        if device.type != "cuda":
            return src.clone()
        buf = torch.empty(src.shape, dtype=torch.int32, pin_memory=True)
        buf.copy_(src)
        return buf.to(device, non_blocking=True)


class Fragment:
    """Dense bitmap fragment for (index, field, view, shard)."""

    def __init__(self, index: str, field: str, view: str, shard: int):
        self.index = index
        self.field = field
        self.view = view
        self.shard = shard
        self._lock = threading.RLock()
        # host master: _words_mem may be spilled to disk by the host-DRAM
        # budget (storage/hostmem.py); the _words property reloads it.
        # Row metadata (_row_of_slot/_slot_of_row) always stays in memory.
        self._words_mem: Optional[np.ndarray] = \
            np.zeros((_INIT_CAP, WORDS_PER_ROW), dtype=np.uint32)
        self._spill_path: Optional[str] = None
        self._spill_gen = -1      # generation persisted in the spill file
        self._finalizer = None
        self._row_of_slot: List[int] = []
        self._slot_of_row: Dict[int, int] = {}
        # device mirror: (rows, W) int32 on self._dev_device, or None
        self._dev: Optional[torch.Tensor] = None
        self._dev_device: Optional[torch.device] = None
        self._dev_rows = -1         # number of valid slots on the device
        self._dev_upload = 0        # full uploads so far (_evict_device)
        self._dirty: set = set()    # slots needing upload
        self._all_dirty = True
        # Seqlock generation: odd while host words mutate, even otherwise
        # (both transitions under self._lock); it starts at a base no other
        # fragment shares.  Each assignment bumps the write clock
        # (__setattr__), which hangs under the view's once installed.
        self.clock = Clock()
        self.generation = _fresh_generation()
        # MVCC overlay: row -> [(even-gen tag, words copy)] ascending
        self._overlay: Dict[int, list] = {}
        self._hkey = ("host", index, field, view, shard, id(self))
        self._register_host()

    def __setattr__(self, name, value):
        # generation stays a plain attribute: the snapshot pin reads it
        # twice a fragment, every fragment of the index, each query, and a
        # property would cost about 2.5 times a plain read
        object.__setattr__(self, name, value)
        if name == "generation":
            self.clock.bump()

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

    # -- host-DRAM residency (the RBF page-cache/mmap role) -----------------

    @property
    def _words(self) -> np.ndarray:
        w = self._words_mem
        if w is None:
            return self._reload_host()
        hostmem().touch(self._host_key())
        return w

    @_words.setter
    def _words(self, v: np.ndarray):
        self._words_mem = v

    def _host_key(self):
        return self._hkey

    def _register_host(self):
        """(Re-)register this fragment's host bytes with the budget
        manager; may synchronously spill other fragments."""
        w = self._words_mem
        if w is None:
            return
        ref = weakref.ref(self)

        def offload():
            f = ref()
            if f is not None:
                f._offload_host()
        hostmem().add(self._host_key(), int(w.nbytes), offload)
        if self._finalizer is None:
            # drop the budget's entry when the fragment is collected (a
            # module-level function: the finalizer must not keep self alive)
            self._finalizer = weakref.finalize(
                self, _drop_host_entry, self._host_key())

    def _offload_host(self):
        """Spill the host words to disk and drop the array (called by the
        host budget under pressure).  Non-blocking on the fragment lock: a
        fragment busy writing, or mid-reload and itself evicting others,
        re-registers and is skipped, since blocking could deadlock two
        fragments evicting each other.  The device mirror and the
        generation are left alone."""
        if not self._lock.acquire(blocking=False):
            self._register_host()
            return
        try:
            w = self._words_mem
            if w is None:
                return
            n = self.num_rows
            if self._spill_path is None:
                import tempfile
                fd, path = tempfile.mkstemp(suffix=".npy", prefix="frag_",
                                            dir=hostmem().spill_dir())
                os.close(fd)
                self._spill_path = path
                weakref.finalize(self, _unlink_spill, path)
            if self._spill_gen != self.generation:
                np.save(self._spill_path, w[:n], allow_pickle=False)
                self._spill_gen = self.generation
            self._words_mem = None
            hostmem().remove(self._host_key())
        finally:
            self._lock.release()

    def _reload_host(self) -> np.ndarray:
        with self._lock:
            if self._words_mem is not None:
                return self._words_mem
            n = self.num_rows
            w = np.zeros((max(_INIT_CAP, n), WORDS_PER_ROW), dtype=np.uint32)
            if self._spill_path is not None and n:
                w[:n] = np.load(self._spill_path, allow_pickle=False)
            self._words_mem = w
            hostmem().note_reload()
            self._register_host()
            return w

    # -- host-side row management ------------------------------------------

    @property
    def num_rows(self) -> int:
        return len(self._row_of_slot)

    def row_ids(self) -> np.ndarray:
        """Sorted row ids present (may include all-zero rows after clears)."""
        return np.array(sorted(self._slot_of_row), dtype=np.uint64)

    def has_row(self, row: int) -> bool:
        return row in self._slot_of_row

    def slot_rows(self) -> List[int]:
        """Row ids in slot order, parallel to device_tile()'s leading axis."""
        return list(self._row_of_slot[: self.num_rows])

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
            self._all_dirty = True
            self._register_host()
        self._row_of_slot.append(row)
        self._slot_of_row[row] = slot
        self._dirty.add(slot)
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
            self._dirty.add(slot)
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
            self._dirty.add(slot)
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

    def merge_row_words(self, row: int, words: np.ndarray,
                        clear: bool = False):
        """OR (or ANDNOT if clear) a dense word vector into a row."""
        with self._lock:
            if clear:
                slot = self._slot_of_row.get(row)
                if slot is None:
                    return
                with self._mutating():
                    self._cow(slot)
                    np.bitwise_and(self._words[slot], ~words,
                                   out=self._words[slot])
            else:
                slot = self._ensure_slot(row)
                with self._mutating():
                    self._cow(slot)
                    np.bitwise_or(self._words[slot], words,
                                  out=self._words[slot])
            self._dirty.add(slot)

    def write_row_words(self, row: int, words: np.ndarray):
        """Replace a row wholesale (reference Store)."""
        with self._lock:
            slot = self._ensure_slot(row)
            with self._mutating():
                self._cow(slot)
                self._words[slot] = words
            self._dirty.add(slot)

    def clear_row(self, row: int):
        """Zero a row; its slot stays, as an all-zero row."""
        with self._lock:
            slot = self._slot_of_row.get(row)
            if slot is not None:
                with self._mutating():
                    self._cow(slot)
                    self._words[slot] = 0
                self._dirty.add(slot)

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
                    self._dirty.add(slot)

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
            self._dirty.update(slots)

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
            self._dirty.update(range(n))

    # -- device mirror ------------------------------------------------------
    # The mirror is a cache entry in the residency LRU (storage/residency.py,
    # the RBF page-cache role, reference rbf/db.go:45): a full upload
    # registers its byte size and may be evicted under memory pressure; the
    # host master is authoritative, so eviction just drops the reference.

    def _residency_key(self):
        return ("frag", self.index, self.field, self.view, self.shard,
                id(self))

    def _evict_device(self, upload: Optional[int] = None):
        """Drop the device mirror (called by the residency LRU; a query in
        flight keeps its tensor alive through its local reference).  The
        LRU names the full upload it registered: an eviction that reaches
        a fragment after a newer upload (another thread's, registered under
        the same key) leaves that one alone."""
        if upload is not None and upload != self._dev_upload:
            return
        self._dev = None
        self._dev_rows = -1
        self._all_dirty = True

    def release_device(self):
        """Drop the device mirror and its residency bytes (the fragment's
        field, view or index was deleted)."""
        from featurebase_tpu_torch.storage.residency import residency
        with self._lock:
            residency().remove(self._residency_key())
            self._evict_device()

    def _flush_to_device(self, device: torch.device) -> torch.Tensor:
        """Bring the mirror up to date on `device`; the caller holds
        self._lock.  A full upload when slots were added, the mirror was
        evicted or the device changed; otherwise only the dirty rows, with
        an out-of-place index_copy, so a tensor already handed to a reader
        never changes under it."""
        from featurebase_tpu_torch.storage.residency import residency
        n = self.num_rows
        dev = self._dev
        if n == 0:
            dev = torch.zeros((0, WORDS_PER_ROW), dtype=torch.int32,
                              device=device)
        elif (self._all_dirty or dev is None or dev.shape[0] < n
              or self._dev_device != device):
            dev = _upload(self._words[:n], device)
            # the mirror is in place before the LRU may evict it
            self._dev_upload += 1
            self._dev, self._dev_device, self._dev_rows = dev, device, n
            self._dirty.clear()
            self._all_dirty = False
            residency().add(self._residency_key(), n * WORDS_PER_ROW * 4,
                            functools.partial(self._evict_device,
                                              self._dev_upload))
            return dev
        elif self._dirty:
            slots = np.array(sorted(self._dirty), dtype=np.int64)
            dev = dev.index_copy(0, torch.as_tensor(slots, device=device),
                                 _upload(self._words[slots], device))
            residency().touch(self._residency_key())
        self._dev, self._dev_device, self._dev_rows = dev, device, n
        self._dirty.clear()
        self._all_dirty = False
        return dev

    def device_tile(self, device) -> torch.Tensor:
        """(num_rows, W) int32 tensor of all rows (slot order) on `device`.
        Under a diverged snapshot pin, an uncached upload of the pinned row
        states (the generation-keyed mirror belongs to live readers)."""
        from featurebase_tpu_torch.model.snapshot import current_pin
        from featurebase_tpu_torch.storage.residency import residency
        device = _canonical(device)
        pin = current_pin()
        with self._lock:
            # the pin decision is made under the fragment lock: writers
            # mutate only while holding it, so pin_current here cannot be
            # invalidated before the flush or cached return below
            if pin is not None and not self.pin_current(pin):
                rows = list(self._row_of_slot[: self.num_rows])
                if not rows:
                    return torch.zeros((0, WORDS_PER_ROW), dtype=torch.int32,
                                       device=device)
                host = np.stack([self._pinned_row(pin, r) for r in rows])
            else:
                dev = self._dev
                if (dev is None or self._all_dirty or self._dirty
                        or self._dev_rows != self.num_rows
                        or self._dev_device != device):
                    return self._flush_to_device(device)
                residency().touch(self._residency_key())
                return dev
        # the pinned build uploads outside the lock: writers are not held
        # for the transfer
        return _upload(host, device)

    def device_row(self, row: int, device) -> torch.Tensor:
        """(W,) int32 device words for one row (zeros if absent)."""
        slot = self._slot_of_row.get(row)
        if slot is None:
            return torch.zeros(WORDS_PER_ROW, dtype=torch.int32,
                               device=_canonical(device))
        return self.device_tile(device)[slot]

    def device_slots(self, rows, device):
        """(tile, slots): device_tile()'s tensor and the slot of each row
        id in it (-1 for a row the fragment lacks), read in one hold of the
        fragment's lock, so the slots index that very tensor (a writer
        replaces the mirror out of place)."""
        with self._lock:
            tile = self.device_tile(device)
            slots = np.array([self._slot_of_row.get(int(r), -1)
                              for r in rows], dtype=np.int64)
        return tile, slots

    def device_rows(self, rows, device):
        """Device rows for a list of row ids, absent rows as zeros:
        (tile (len(rows), W) int32, present (len(rows),) bool ndarray)."""
        from featurebase_tpu_torch.model.snapshot import current_pin
        device = _canonical(device)
        pin = current_pin()
        host = None
        with self._lock:  # pin decision and slot lookups atomic vs writers
            present = np.array([self._slot_of_row.get(int(r)) is not None
                                for r in rows], dtype=bool)
            if pin is not None and not self.pin_current(pin):
                host = np.zeros((len(rows), WORDS_PER_ROW), dtype=np.uint32)
                for i, r in enumerate(rows):
                    host[i] = self._pinned_row(pin, int(r))
            else:
                tile = self.device_tile(device)
                slots = np.array([self._slot_of_row.get(int(r), 0)
                                  for r in rows], dtype=np.int64)
        if host is not None:  # upload outside the lock (see device_tile)
            return _upload(host, device), present
        if tile.shape[0] == 0:
            return torch.zeros((len(rows), WORDS_PER_ROW), dtype=torch.int32,
                               device=device), present
        if present.all() and np.array_equal(
                slots, np.arange(slots[0], slots[0] + len(slots))):
            # consecutive slots (a BSI group, a field's rows in import
            # order): a view of the mirror, with no index upload, which
            # from pageable host memory can wait on the stream
            return tile[slots[0]:slots[0] + len(slots)], present
        gathered = tile.index_select(0, torch.as_tensor(slots, device=device))
        mask = torch.as_tensor(present, device=device)[:, None]
        return torch.where(mask, gathered, 0), present

    # -- anti-entropy -------------------------------------------------------

    @property
    def writes_generation(self) -> int:
        """The generation counted from the fragment's own base: two steps a
        write, as the JAX package's generations count from 0, so that
        replicas compare how many writes each has seen."""
        return self.generation % _GENERATION_SPAN

    def checksum(self) -> int:
        """CRC32 over (row ids, words), the per-fragment checksum of the
        JAX package's snapshots and resync (reference holder.go:1303);
        cached by generation."""
        import zlib
        with self._lock:
            cached = getattr(self, "_cksum", None)
            if cached is not None and cached[0] == self.generation:
                return cached[1]
            n = self.num_rows
            crc = zlib.crc32(
                np.array(self._row_of_slot[:n], dtype=np.int64).tobytes())
            crc = zlib.crc32(np.ascontiguousarray(self._words[:n]).tobytes(),
                             crc)
            self._cksum = (self.generation, crc)
            return crc

    # -- persistence --------------------------------------------------------

    def to_npz_dict(self) -> dict:
        n = self.num_rows
        return {"rows": np.array(self._row_of_slot[:n], dtype=np.int64),
                "words": self._words[:n]}

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
        f._register_host()
        return f
