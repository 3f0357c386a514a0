"""Field: a typed column of the data model (host masters and write API).

Own copy of featurebase_tpu/model/field.py trimmed to what the port's slice
uses: options and their schema document, value encoding and decoding,
views (deleted with their device copies, and by the TTL), point writes (a
bit or a value, set or cleared) and bulk writes, the TopN rank cache, the
per-shard BSI group on the fragment mirror, one column's value or a
shard's values decoded on the host, and the placement gate of a mesh that
spans processes (``_writable``/``note_shard``, parallel/placement.py): a
write for a shard this process does not own keeps the shard and row ids
as metadata and drops the payload.  Mirrors
reference field.go:73 (Field), field types field.go:42-50 and the
bsiGroup value encoding (field.go:2394 bsiGroup, 2412 baseValue).

BSI encoding: int-like values are stored relative to `base` as sign-magnitude
bit slices in the `bsig_<field>` view — row 0 exists, row 1 sign, row 2+i =
magnitude bit i (reference fragment.go:62-65).
"""
from __future__ import annotations

import os
import threading
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np

from featurebase_tpu_torch.core.consts import (BSI_EXISTS_ROW, BSI_OFFSET,
                                               BSI_SIGN_ROW, SHARD_WIDTH)
from featurebase_tpu_torch.model.timequantum import (parse_time,
                                                     views_by_time,
                                                     views_by_time_range)
from featurebase_tpu_torch.model.view import (VIEW_STANDARD, View,
                                              view_bsi_group)

# field types (reference field.go:42-50)
TYPE_SET = "set"
TYPE_INT = "int"
TYPE_TIME = "time"
TYPE_MUTEX = "mutex"
TYPE_BOOL = "bool"
TYPE_DECIMAL = "decimal"
TYPE_TIMESTAMP = "timestamp"

BSI_TYPES = (TYPE_INT, TYPE_DECIMAL, TYPE_TIMESTAMP)

# Paranoia mode (reference: roaringparanoia build tag,
# roaring/roaring_paranoia.go:3 — invariant validation on every mutation).
# FEATUREBASE_TPU_PARANOIA=1 turns on per-write invariant checks: mutex/bool
# columns hold at most one row bit; BSI columns with magnitude or sign bits
# always carry the exists bit.  The JAX package's own variable, read at
# import as it reads it (featurebase_tpu/model/field.py:37-48).
PARANOIA = os.environ.get("FEATUREBASE_TPU_PARANOIA", "") not in ("", "0")


class ParanoiaError(AssertionError):
    pass

# cache types (reference field.go:2486 CacheType*)
CACHE_RANKED = "ranked"
CACHE_LRU = "lru"
CACHE_NONE = "none"

DEFAULT_CACHE_SIZE = 50000

_EPOCH = datetime(1970, 1, 1)

_TIME_UNIT_NS = {
    "s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "µs": 1_000, "ns": 1,
    "m": 60 * 1_000_000_000, "h": 3600 * 1_000_000_000,
    "d": 86400 * 1_000_000_000,
}


def _by_shard(cols: np.ndarray):
    """(shard, indices of its columns in input order) for each shard the
    columns reach, in shard order: one stable sort, where a mask a shard
    would scan every column once per shard."""
    shards = cols >> 20
    order = np.argsort(shards, kind="stable")
    uniq, starts = np.unique(shards[order], return_index=True)
    bounds = np.append(starts, order.size)
    return [(int(s), order[bounds[i]:bounds[i + 1]])
            for i, s in enumerate(uniq)]


class FieldOptions:
    def __init__(self, type: str = TYPE_SET, keys: bool = False,
                 cache_type: str = CACHE_RANKED,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 min: Optional[int] = None, max: Optional[int] = None,
                 scale: int = 0, time_unit: str = "s",
                 time_quantum: str = "", ttl: int = 0,
                 no_standard_view: bool = False,
                 foreign_index: str = ""):
        self.type = type
        self.keys = keys
        self.cache_type = cache_type
        self.cache_size = cache_size
        self.min = min
        self.max = max
        self.scale = scale
        self.time_unit = time_unit
        self.time_quantum = time_quantum
        self.ttl = ttl
        self.no_standard_view = no_standard_view
        self.foreign_index = foreign_index

    def to_json(self):
        return {
            "type": self.type, "keys": self.keys,
            "cacheType": self.cache_type, "cacheSize": self.cache_size,
            "min": self.min, "max": self.max, "scale": self.scale,
            "timeUnit": self.time_unit, "timeQuantum": self.time_quantum,
            "ttl": self.ttl, "noStandardView": self.no_standard_view,
            "foreignIndex": self.foreign_index,
        }

    @classmethod
    def from_json(cls, d: dict) -> "FieldOptions":
        return cls(type=d.get("type", TYPE_SET), keys=d.get("keys", False),
                   cache_type=d.get("cacheType", CACHE_RANKED),
                   cache_size=d.get("cacheSize", DEFAULT_CACHE_SIZE),
                   min=d.get("min"), max=d.get("max"),
                   scale=d.get("scale", 0),
                   time_unit=d.get("timeUnit", "s"),
                   time_quantum=d.get("timeQuantum", ""),
                   ttl=d.get("ttl", 0),
                   no_standard_view=d.get("noStandardView", False),
                   foreign_index=d.get("foreignIndex", ""))


class Field:
    def __init__(self, index: str, name: str, options: FieldOptions):
        self.index = index
        self.name = name
        self.options = options
        self._lock = threading.RLock()
        self.views: Dict[str, View] = {}
        # TopN rank cache: (shard, views) -> (generations, {row: count})
        # (reference: cache.go:25 rankCache; exact counts per shard keyed by
        # fragment generation, honoring cache_type/cache_size)
        self._topn_cache: Dict = {}
        # owner-placed host masters (parallel/placement.py): shards seen in
        # gated (unowned) writes and row-id metadata per view, so that every
        # process agrees on the global shard set and candidate row ids
        # without holding the data (reference: shard metadata lives in etcd
        # via Sharder, disco/disco.go:113)
        self._known_shards: set = set()
        self._meta_rows: Dict[str, set] = {}
        # dynamic bit depth for BSI fields (grows with observed magnitudes)
        self.bit_depth = self._initial_depth() if self.is_bsi() else 0
        # base for value encoding (reference field.go:2412 baseValue)
        self.base = self._compute_base()

    # -- type helpers -------------------------------------------------------

    def is_bsi(self) -> bool:
        return self.options.type in BSI_TYPES

    def _compute_base(self) -> int:
        o = self.options
        if not self.is_bsi() or o.min is None or o.max is None:
            return 0
        if o.min > 0:
            return o.min
        if o.max < 0:
            return o.max
        return 0

    def _initial_depth(self) -> int:
        o = self.options
        if o.min is None or o.max is None:
            return 1
        base = self._compute_base()
        mag = max(abs(int(o.min) - base), abs(int(o.max) - base))
        return max(1, mag.bit_length())

    def time_quantum(self) -> str:
        return self.options.time_quantum \
            if self.options.type == TYPE_TIME else ""

    # -- value encoding (field-level units -> stored BSI int) ---------------

    def encode_value(self, v) -> int:
        o = self.options
        if o.type == TYPE_DECIMAL:
            if isinstance(v, str):
                v = float(v)
            if isinstance(v, float):
                v = round(v * (10 ** o.scale))
            elif isinstance(v, int):
                v = v * (10 ** o.scale)
            return int(v)
        if o.type == TYPE_TIMESTAMP:
            if isinstance(v, (int, np.integer)):
                return int(v)
            t = parse_time(v)
            ns = int((t - _EPOCH).total_seconds() * 1e9)
            return ns // _TIME_UNIT_NS.get(o.time_unit, 1_000_000_000)
        return int(v)

    def decode_value(self, stored: int):
        """A stored value (base added) in field units: scaled for decimals."""
        if self.options.type == TYPE_DECIMAL:
            return stored / (10 ** self.options.scale)
        return int(stored)

    # -- views --------------------------------------------------------------

    def view(self, name: str) -> Optional[View]:
        return self.views.get(name)

    def create_view_if_not_exists(self, name: str) -> View:
        with self._lock:
            v = self.views.get(name)
            if v is None:
                v = View(self.index, self.name, name)
                self.views[name] = v
            return v

    def bsi_view(self) -> View:
        return self.create_view_if_not_exists(view_bsi_group(self.name))

    def standard_view(self) -> View:
        return self.create_view_if_not_exists(VIEW_STANDARD)

    def available_shards(self) -> List[int]:
        shards = set(self._known_shards)
        for v in self.views.values():
            shards.update(v.available_shards())
        return sorted(shards)

    def release_device(self, view: Optional[str] = None) -> None:
        """Drop every device copy of the field (of one of its views): the
        fragments' mirrors and every plan executor's stacked entries
        gathered from them, with their residency bytes, and the rank
        cache's entries over it."""
        from featurebase_tpu_torch.executor.plan import drop_fragment_copies
        frags = [fr for vn, v in list(self.views.items())
                 if view in (None, vn) for fr in list(v.fragments.values())]
        for frag in frags:
            frag.release_device()
        drop_fragment_copies({id(fr) for fr in frags})
        for key in list(self._topn_cache):
            if view is None or view in key[1]:
                self._topn_cache.pop(key, None)

    def delete_view(self, name: str):
        with self._lock:
            if name not in self.views:
                return
            self.release_device(name)
            self.views.pop(name, None)

    # -- owner placement (a mesh over processes; parallel/placement.py) -----

    def _writable(self, shard: int) -> bool:
        """False when an ownership policy is active and this process does
        not own the shard: the caller records metadata and drops the
        payload (reference: a computer only loads directive-assigned
        shards, api_directive.go:559)."""
        from featurebase_tpu_torch.parallel import placement
        if not placement.active() or placement.owns(self.index, int(shard)):
            return True
        self._known_shards.add(int(shard))
        return False

    def note_shard(self, view_name: str, shard: int, rows) -> None:
        """Record shard and row-id metadata without data (gated writes)."""
        self._known_shards.add(int(shard))
        self._meta_rows.setdefault(view_name, set()).update(
            int(r) for r in rows)

    def _meta_note(self, view_name: str, rows) -> None:
        """Row-id metadata for owned writes too, only while a placement
        policy is active (every process sees the same write stream, so the
        union agrees globally)."""
        from featurebase_tpu_torch.parallel import placement
        if placement.active():
            self._meta_rows.setdefault(view_name, set()).update(
                int(r) for r in rows)

    def meta_rows(self, view_names) -> set:
        """Globally agreed candidate row ids of the views (empty unless an
        ownership policy is active); may include rows whose bits were since
        cleared, as Fragment.row_ids may."""
        from featurebase_tpu_torch.parallel import placement
        if not placement.active():
            return set()
        out: set = set()
        for vn in view_names:
            out |= self._meta_rows.get(vn, set())
        return out

    # -- bit-level writes (set/mutex/bool/time) -----------------------------

    def set_bit(self, row: int, col: int, timestamp=None) -> bool:
        """Reference field.SetBit field.go:1301."""
        o = self.options
        shard = col >> 20
        self._meta_note(VIEW_STANDARD, (row,))
        if not self._writable(shard):
            vns = [VIEW_STANDARD]
            if o.type == TYPE_TIME and timestamp is not None:
                vns += views_by_time(VIEW_STANDARD, parse_time(timestamp),
                                     o.time_quantum)
            for vn in vns:
                self.note_shard(vn, shard, (row,))
            return False
        if o.type in (TYPE_MUTEX, TYPE_BOOL):
            self._clear_mutex_col(col, keep_row=row)
        if o.type == TYPE_TIME:
            views = [] if o.no_standard_view else [VIEW_STANDARD]
            if timestamp is not None:
                views.extend(views_by_time(VIEW_STANDARD,
                                           parse_time(timestamp),
                                           o.time_quantum))
            changed = False
            for vn in views:
                self._meta_note(vn, (row,))
                frag = self.create_view_if_not_exists(vn) \
                    .create_fragment_if_not_exists(shard)
                if frag.set_bit(row, col):
                    changed = True
                    self._topn_cache_adjust(shard, vn, row, +1)
            return changed
        frag = self.standard_view().create_fragment_if_not_exists(shard)
        out = frag.set_bit(row, col)
        if out:
            self._topn_cache_adjust(shard, VIEW_STANDARD, row, +1)
        if PARANOIA:
            self._paranoia_column(col)
        return out

    def clear_bit(self, row: int, col: int) -> bool:
        """Clear a bit in every view of the column's shard (reference
        field.ClearBit)."""
        shard = col >> 20
        changed = False
        for vn, v in list(self.views.items()):
            frag = v.fragment(shard)
            if frag is not None and frag.clear_bit(row, col):
                changed = True
                self._topn_cache_adjust(shard, vn, row, -1)
        return changed

    def _topn_cache_adjust(self, shard: int, view_name: str, row: int,
                           delta: int):
        """Incremental rank-cache maintenance for single-bit writes
        (reference: cache.go:130).  The entry is updated only when the
        current generations equal the cached ones plus exactly this write's
        seqlock bump; otherwise it drops."""
        for key in list(self._topn_cache):
            kshard, names = key
            if kshard != shard or view_name not in names:
                continue
            if names != (view_name,):
                self._topn_cache.pop(key, None)
                continue
            entry = self._topn_cache.get(key)
            if entry is None:
                continue
            old_gens, counts = entry
            cur = tuple(fr.generation for vn in names
                        if (vv := self.views.get(vn)) is not None
                        and (fr := vv.fragments.get(shard)) is not None)
            if (len(cur) != len(old_gens)
                    or sum(c - o for c, o in zip(cur, old_gens)) != 2
                    or any(c - o not in (0, 2)
                           for c, o in zip(cur, old_gens))):
                self._topn_cache.pop(key, None)
                continue
            new_counts = dict(counts)
            new_counts[row] = new_counts.get(row, 0) + delta
            if new_counts[row] <= 0:
                new_counts.pop(row)
            if len(new_counts) > self.options.cache_size:
                self._topn_cache.pop(key, None)
                continue
            self._topn_cache[key] = (cur, new_counts)

    def _clear_mutex_col(self, col: int, keep_row: Optional[int] = None):
        """Mutex invariant: at most one row set per column (reference
        fragment.go:1787 bulkImportMutex)."""
        v = self.views.get(VIEW_STANDARD)
        frag = v.fragment(col >> 20) if v is not None else None
        if frag is None:
            return
        for r in list(frag.row_ids()):
            r = int(r)
            if r != keep_row and frag.get_bit(r, col):
                frag.clear_bit(r, col)

    # -- bulk imports -------------------------------------------------------

    def _check_value_range(self, stored_with_base) -> None:
        """Writes outside the configured [min, max] are rejected
        (reference: fragment.go:615 setValue range errors)."""
        o = self.options
        if o.min is not None and stored_with_base < self.encode_value(o.min):
            raise ValueError(
                f"value {stored_with_base} below field minimum {o.min}")
        if o.max is not None and stored_with_base > self.encode_value(o.max):
            raise ValueError(
                f"value {stored_with_base} above field maximum {o.max}")

    # -- BSI point writes (reference fragment.setValue:615) -----------------

    def set_value(self, col: int, value) -> bool:
        """Write one column's value; raises ValueError outside [min, max].
        The depth grows to the value's magnitude."""
        stored = self.encode_value(value) - self.base
        self._check_value_range(stored + self.base)
        mag = abs(stored)
        if not self._writable(col >> 20):
            self.note_shard(view_bsi_group(self.name), col >> 20, ())
            self.bit_depth = max(self.bit_depth, mag.bit_length(), 1)
            return False
        frag = self.bsi_view().create_fragment_if_not_exists(col >> 20)
        depth = max(self.bit_depth, mag.bit_length(), 1)
        self.bit_depth = depth
        changed = frag.set_bit(BSI_EXISTS_ROW, col)
        if stored < 0:
            changed |= frag.set_bit(BSI_SIGN_ROW, col)
        else:
            changed |= frag.clear_bit(BSI_SIGN_ROW, col)
        for i in range(depth):
            if (mag >> i) & 1:
                changed |= frag.set_bit(BSI_OFFSET + i, col)
            else:
                changed |= frag.clear_bit(BSI_OFFSET + i, col)
        if PARANOIA:
            self._paranoia_column(col)
        return changed

    def clear_value(self, col: int) -> bool:
        """Remove one column's value; True when it had one."""
        v = self.views.get(view_bsi_group(self.name))
        frag = v.fragment(col >> 20) if v else None
        if frag is None:
            return False
        changed = frag.clear_bit(BSI_EXISTS_ROW, col)
        frag.clear_bit(BSI_SIGN_ROW, col)
        for i in range(self.bit_depth):
            frag.clear_bit(BSI_OFFSET + i, col)
        return changed

    def import_bits(self, rows: np.ndarray, cols: np.ndarray,
                    timestamps=None, clear: bool = False):
        """Bulk set-bit import (reference fragment.bulkImport:1498; mutex
        variant 1787; time-view fan-out field.Import field.go:1662)."""
        from featurebase_tpu_torch.ops.bitwise import cols_to_words
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        o = self.options
        for s, m in _by_shard(cols):
            r, c = rows[m], cols[m] % SHARD_WIDTH
            self._meta_note(VIEW_STANDARD, np.unique(r))
            if not self._writable(s):
                self.note_shard(VIEW_STANDARD, s, np.unique(r))
                if o.type == TYPE_TIME and timestamps is not None:
                    for t in np.asarray(timestamps)[m]:
                        for vn in views_by_time(VIEW_STANDARD, parse_time(t),
                                                o.time_quantum):
                            self.note_shard(vn, s, np.unique(r))
                continue
            frag = self.standard_view().create_fragment_if_not_exists(s)
            if o.type in (TYPE_MUTEX, TYPE_BOOL) and not clear:
                # clear the imported columns across all rows first
                frag.clear_columns(cols_to_words(np.unique(c)))
            frag.import_bits(r, c, clear=clear)
            if o.type == TYPE_TIME and timestamps is not None:
                ts = np.asarray(timestamps)[m]
                per_t = [views_by_time(VIEW_STANDARD, parse_time(t),
                                       o.time_quantum) for t in ts]
                for vn in {v for vs in per_t for v in vs}:
                    tf = self.create_view_if_not_exists(vn) \
                        .create_fragment_if_not_exists(s)
                    sel = np.array([vn in vs for vs in per_t])
                    tf.import_bits(r[sel], c[sel], clear=clear)

    def encode_values_vec(self, values) -> np.ndarray:
        """Vectorized encode_value over a batch."""
        o = self.options
        arr = np.asarray(values)
        if arr.dtype.kind in "iu":
            if o.type == TYPE_DECIMAL:
                return arr.astype(np.int64) * (10 ** o.scale)
            return arr.astype(np.int64)
        if arr.dtype.kind == "f" and o.type == TYPE_DECIMAL:
            return np.round(arr * (10 ** o.scale)).astype(np.int64)
        return np.array([self.encode_value(v) for v in values],
                        dtype=np.int64)

    @staticmethod
    def _bsi_delta(c, v, mg, depth: int, device=None) -> np.ndarray:
        """(depth+2, W) delta tile for one shard's BSI import.  On the host
        by default: the columns sorted, each plane's bits ORed over each
        word's columns, so a column given twice ORs its values' bits as
        the JAX package's scatter does, at a cost that follows the
        columns.  With FEATUREBASE_TPU_DEVICE_INGEST=1 and depth <= 31 (as
        featurebase_tpu/model/field.py:492-506 reads them) the tile is
        built on `device` (the API's; the CPU when None) by
        ops/bsi.py::bsi_delta_device and copied back."""
        if os.environ.get("FEATUREBASE_TPU_DEVICE_INGEST") == "1" \
                and depth <= 31:
            import torch

            from featurebase_tpu_torch.ops.bsi import bsi_delta_device
            dev = torch.device(device if device is not None else "cpu")
            tile = bsi_delta_device(
                torch.from_numpy(np.asarray(c, dtype=np.int64)).to(dev),
                torch.from_numpy(np.asarray(mg).astype(np.int64)).to(dev),
                torch.from_numpy(np.asarray(v) < 0).to(dev), depth)
            return tile.cpu().numpy().view(np.uint32)
        order = np.argsort(c, kind="stable")
        cs = c[order]
        wi = cs >> 5
        starts = np.flatnonzero(np.r_[True, wi[1:] != wi[:-1]])
        b = (cs & 31).astype(np.uint32)
        planes = np.empty((depth + 2, cs.size), dtype=np.uint32)
        np.left_shift(np.uint32(1), b, out=planes[0])            # exists
        np.left_shift((v[order] < 0).astype(np.uint32), b,
                      out=planes[1])                             # sign
        p = planes[2:]          # each magnitude bit, truncated to uint32
        np.right_shift(mg[order], np.arange(depth, dtype=np.uint64)[:, None],
                       out=p, casting="same_kind")
        np.bitwise_and(p, 1, out=p)
        np.left_shift(p, b, out=p)
        delta = np.zeros((depth + 2, SHARD_WIDTH // 32), dtype=np.uint32)
        delta[:, wi[starts]] = np.bitwise_or.reduceat(planes, starts, axis=1)
        return delta

    def import_values(self, cols: np.ndarray, values, clear: bool = False,
                      device=None):
        """Bulk BSI import (reference fragment.importValue:1947): one OR
        over the sorted columns builds a (depth+2, W) delta tile per shard
        (_bsi_delta), which lands in the fragment in one locked OR after
        the imported columns are cleared.  With `clear`, each column's
        value is removed (the values are range-checked all the same, as
        the JAX package does).  `device` is where a device ingest builds
        its tiles (_bsi_delta)."""
        cols = np.asarray(cols, dtype=np.int64)
        encoded = self.encode_values_vec(values)
        o = self.options
        if encoded.size and (o.min is not None or o.max is not None):
            self._check_value_range(int(encoded.min()))
            self._check_value_range(int(encoded.max()))
        if clear:
            for c in cols:
                self.clear_value(int(c))
            return
        stored = encoded - self.base
        mags = np.abs(stored)
        depth = max(self.bit_depth,
                    int(mags.max()).bit_length() if mags.size else 1, 1)
        self.bit_depth = depth
        for s, m in _by_shard(cols):
            if not self._writable(s):
                self.note_shard(view_bsi_group(self.name), s, ())
                continue
            frag = self.bsi_view().create_fragment_if_not_exists(s)
            delta = self._bsi_delta(cols[m] % SHARD_WIDTH, stored[m],
                                    mags[m].astype(np.uint64), depth, device)
            frag.clear_columns(delta[0])
            frag.merge_rows_delta(
                [BSI_EXISTS_ROW, BSI_SIGN_ROW] +
                [BSI_OFFSET + i for i in range(depth)], delta)

    # -- per-shard device data ----------------------------------------------

    def bsi_data(self, shard: int, device):
        """(group (D + 2, W) int32 on `device`, depth) of one shard, from
        its fragment's device mirror (absent planes zero), or None without
        data (featurebase_tpu/model/field.py:564)."""
        v = self.views.get(view_bsi_group(self.name))
        frag = v.fragment(shard) if v else None
        if frag is None or frag.num_rows == 0:
            return None
        depth = max(self.bit_depth, 1)
        rows = [BSI_EXISTS_ROW, BSI_SIGN_ROW] + \
            [BSI_OFFSET + i for i in range(depth)]
        tile, _ = frag.device_rows(rows, device)
        return tile, depth

    def _paranoia_column(self, col: int):
        """Per-write invariant validation (reference: roaringparanoia
        checks, roaring/roaring_paranoia.go:3).  Raises ParanoiaError on a
        broken invariant — only active with FEATUREBASE_TPU_PARANOIA=1."""
        o = self.options
        if o.type in (TYPE_MUTEX, TYPE_BOOL):
            v = self.views.get(VIEW_STANDARD)
            frag = v.fragment(col >> 20) if v else None
            if frag is None:
                return
            set_rows = [r for r in frag.slot_rows()
                        if frag.get_bit(int(r), col)]
            if len(set_rows) > 1:
                raise ParanoiaError(
                    f"{o.type} field {self.name}: column {col} has "
                    f"{len(set_rows)} rows set: {set_rows}")
        elif self.is_bsi():
            v = self.views.get(view_bsi_group(self.name))
            frag = v.fragment(col >> 20) if v else None
            if frag is None:
                return
            exists = frag.get_bit(BSI_EXISTS_ROW, col)
            has_data = frag.get_bit(BSI_SIGN_ROW, col) or any(
                frag.get_bit(BSI_OFFSET + i, col)
                for i in range(max(self.bit_depth, 1)))
            if has_data and not exists:
                raise ParanoiaError(
                    f"BSI field {self.name}: column {col} has magnitude/"
                    "sign bits without the exists bit")

    def value(self, col: int):
        """(value with base, True) of one column, or (0, False) without one
        (reference fragment.go:579 value), from the host master bits."""
        v = self.views.get(view_bsi_group(self.name))
        frag = v.fragment(col >> 20) if v else None
        if frag is None or not frag.get_bit(BSI_EXISTS_ROW, col):
            return 0, False
        mag = 0
        for i in range(self.bit_depth):
            if frag.get_bit(BSI_OFFSET + i, col):
                mag |= 1 << i
        if frag.get_bit(BSI_SIGN_ROW, col):
            mag = -mag
        return mag + self.base, True

    def values_dense_host(self, shard: int):
        """(values (SHARD_WIDTH,) int64 unbased, exists (SHARD_WIDTH,) bool)
        of one shard decoded on the host, for any depth up to 62, or None
        without data (ops/decode.py decode_values_host)."""
        from featurebase_tpu_torch.ops.decode import (decode_values_host,
                                                      expand_bits_host)
        v = self.views.get(view_bsi_group(self.name))
        frag = v.fragment(shard) if v else None
        if frag is None or frag.num_rows == 0:
            return None
        depth = max(self.bit_depth, 1)
        slices = np.stack([frag.host_row(BSI_OFFSET + i)
                           for i in range(depth)])
        vals = decode_values_host(slices, frag.host_row(BSI_SIGN_ROW), depth)
        return vals, expand_bits_host(frag.host_row(BSI_EXISTS_ROW))

    # -- views for a time range --------------------------------------------

    def views_for_range(self, from_t, to_t) -> List[str]:
        from featurebase_tpu_torch.model.timequantum import view_time_range
        lo, hi = parse_time(from_t), parse_time(to_t)
        # clamp open-ended bounds to the hull of existing time views
        starts, ends = [], []
        for vn in self.views:
            rng = view_time_range(vn)
            if rng is not None:
                starts.append(rng[0])
                ends.append(rng[1])
        if not starts:
            return []
        lo = max(lo, min(starts))
        hi = min(hi, max(ends))
        if lo >= hi:
            return []
        return views_by_time_range(VIEW_STANDARD, lo, hi,
                                   self.options.time_quantum)

    def remove_expired_views(self, now: Optional[datetime] = None
                             ) -> List[str]:
        """Delete the time-quantum views whose period ended more than `ttl`
        seconds before `now` (reference server.go:920 ViewsRemoval), with
        their device copies; returns the removed view names."""
        from featurebase_tpu_torch.model.timequantum import view_time_range
        if self.options.type != TYPE_TIME or self.options.ttl <= 0:
            return []
        now = now or datetime.utcnow()
        removed = []
        for vn in list(self.views):
            rng = view_time_range(vn)
            if rng is None:
                continue
            if (now - rng[1]).total_seconds() > self.options.ttl:
                self.delete_view(vn)
                removed.append(vn)
        return removed

    def to_info(self):
        return {"name": self.name, "options": self.options.to_json(),
                "views": sorted(self.views)}
