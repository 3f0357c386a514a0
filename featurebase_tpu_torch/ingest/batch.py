"""Record-batch ingest.

Mirrors the reference's client-side Batch (reference: batch/batch.go:55
RecordBatch iface, Add:459, Import:753 — doTranslation:860, makeFragments:
1327, doImportShardTransactional:1146): records accumulate into per-field
columnar buffers; import_batch() bulk-translates keys and feeds each field
through the API's bulk imports (API.import_bits / import_values), so every
batch is WAL-logged and lands under the index's mutate gate.

Own copy of Batch and csv_ingest of featurebase_tpu/ingest/batch.py.  The
keys are created in the JAX package's order (column keys as they come, a
field's row keys sorted), so both packages give a batch the same ids.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from featurebase_tpu_torch.model.field import Field
from featurebase_tpu_torch.server.api import API, APIError


class Batch:
    def __init__(self, api: API, index: str, fields: List[str],
                 size: int = 1 << 16):
        self.api = api
        self.index = index
        self.fields = fields
        self.size = size
        idx = api.holder.index(index)
        if idx is None:
            raise APIError(f"index not found: {index}", 404)
        self.idx = idx
        self._field_objs: Dict[str, Field] = {}
        for fname in fields:
            f = idx.field(fname)
            if f is None:
                raise APIError(f"field not found: {fname}", 404)
            self._field_objs[fname] = f
        self._ids: List[Any] = []
        self._values: Dict[str, List[Any]] = {f: [] for f in fields}

    def __len__(self):
        return len(self._ids)

    def add(self, record_id, **values):
        """Add one record; flushes automatically when the batch is full
        (reference batch.Add -> ErrBatchNowFull)."""
        self._ids.append(record_id)
        for fname in self.fields:
            self._values[fname].append(values.get(fname))
        if len(self._ids) >= self.size:
            self.import_batch()

    def import_batch(self):
        """Translate + bulk import everything buffered (reference
        batch.Import batch/batch.go:753)."""
        if not self._ids:
            return
        ids = self._ids
        # -- column key translation (reference doTranslation:860)
        if self.idx.options.keys:
            str_keys = [i for i in ids if isinstance(i, str)]
            mapping = self.api.create_index_keys(self.index, str_keys) \
                if str_keys else {}
            cols = np.array([mapping[i] if isinstance(i, str) else int(i)
                             for i in ids], dtype=np.int64)
        else:
            cols = np.array([int(i) for i in ids], dtype=np.int64)
        self._import_fields(cols)
        # records whose every field is null exist all the same
        with self.idx.mutate_gate.shared():
            self.idx.mark_exists(cols)
        self._ids = []
        self._values = {f: [] for f in self.fields}

    def _import_fields(self, cols):
        for fname, f in self._field_objs.items():
            vals = self._values[fname]
            present = np.array([v is not None for v in vals], dtype=bool)
            if not present.any():
                continue
            pcols = cols[present]
            pvals = [v for v in vals if v is not None]
            if f.is_bsi():
                self.api.import_values(self.index, fname, pcols, pvals)
            elif f.options.type == "bool":
                rows = np.array([1 if v in (True, 1, "true") else 0
                                 for v in pvals], dtype=np.int64)
                self.api.import_bits(self.index, fname, rows, pcols)
            else:
                self._import_set(fname, pcols, pvals)

    def _import_set(self, fname, pcols, pvals):
        """set/mutex/time values: scalars or lists, strings are row keys,
        a (value, timestamp) pair sets a time view too."""
        flat_rows: List[int] = []
        flat_cols: List[int] = []
        flat_ts: List[Any] = []
        str_rows = set()
        for v in pvals:
            for x in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(x, tuple) and len(x) == 2:
                    x = x[0]
                if isinstance(x, str):
                    str_rows.add(x)
        row_map = {}
        if str_rows:
            if self.idx.row_translation(fname) is None:
                raise APIError(f"field {fname} does not use row keys", 400)
            row_map = self.api.create_field_keys(self.index, fname,
                                                 sorted(str_rows))
        for c, v in zip(pcols, pvals):
            for x in (v if isinstance(v, (list, tuple)) else [v]):
                ts = None
                if isinstance(x, tuple) and len(x) == 2:
                    x, ts = x
                flat_rows.append(row_map[x] if isinstance(x, str)
                                 else int(x))
                flat_cols.append(int(c))
                flat_ts.append(ts)
        if flat_rows:
            ts_arr = flat_ts if any(t is not None for t in flat_ts) \
                else None
            self.api.import_bits(self.index, fname, flat_rows, flat_cols,
                                 timestamps=ts_arr)


def csv_ingest(api: API, index: str, path: str, id_column: str = "id",
               batch_size: int = 1 << 16, create_fields: bool = True,
               delimiter: str = ",") -> int:
    """Simple CSV loader (reference idk CSV ingester idk/csv; type inference
    by sampling: int columns -> int fields, everything else -> keyed mutex).
    Returns number of records ingested."""
    import csv as _csv
    idx = api.holder.index(index)
    if idx is None:
        api.create_index(index, {"keys": False})
        idx = api.holder.index(index)
    with open(path, newline="") as fh:
        reader = _csv.DictReader(fh, delimiter=delimiter)
        headers = [h for h in (reader.fieldnames or []) if h != id_column]
        rows = list(reader)
    if create_fields:
        for h in headers:
            if idx.field(h) is None:
                # infer: all-int column -> int field, else keyed mutex
                vals = [r[h] for r in rows if r.get(h)]
                is_int = all(_is_int(v) for v in vals) and vals
                if is_int:
                    iv = [int(v) for v in vals]
                    api.create_field(index, h, {
                        "type": "int", "min": min(iv), "max": max(iv)})
                else:
                    api.create_field(index, h,
                                     {"type": "mutex", "keys": True})
    batch = Batch(api, index, headers, size=batch_size)
    n = 0
    for r in rows:
        rid = r.get(id_column)
        if rid is None:
            continue
        vals = {}
        for h in headers:
            v = r.get(h)
            if v is None or v == "":
                continue
            f = idx.field(h)
            vals[h] = int(v) if f.is_bsi() and _is_int(v) else v
        batch.add(int(rid) if _is_int(rid) else rid, **vals)
        n += 1
    batch.import_batch()
    return n


def _is_int(v: str) -> bool:
    try:
        int(v)
        return True
    except (TypeError, ValueError):
        return False
