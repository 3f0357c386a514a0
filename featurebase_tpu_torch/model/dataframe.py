"""Per-shard columnar dataframe store.

Mirrors the reference's optional Arrow/Parquet side-store (reference:
arrow.go:1-562 — per-shard `_dataframe` dirs of arrow tables alongside the
bitmaps; ingest via /index/{i}/dataframe/{shard} http_handler.go:506; the
Arrow() PQL call returns the filtered table, arrow.go:36 executeArrow).

Backed by numpy column dicts with pyarrow/parquet import-export at the
edges; rows are addressed by `_id` so bitmap filters compose with the
columnar data.

Own copy of featurebase_tpu/model/dataframe.py.
"""
from __future__ import annotations

import io
import threading
from typing import Dict, List, Optional

import numpy as np


class ShardDataframe:
    def __init__(self, shard: int):
        self.shard = shard
        self.columns: Dict[str, np.ndarray] = {"_id": np.empty(0, np.int64)}

    def append(self, columns: Dict[str, list]):
        if "_id" not in columns:
            raise ValueError("dataframe payload requires an _id column")
        n = len(columns["_id"])
        base = self.columns["_id"].size  # rows present before this batch
        for name, vals in columns.items():
            if len(vals) != n:
                raise ValueError("dataframe columns must be equal length")
            arr = np.asarray(vals)
            cur = self.columns.get(name)
            if cur is None or cur.size == 0:
                cur = np.zeros(base, dtype=arr.dtype) if name != "_id" \
                    else np.empty(0, np.int64)
            self.columns[name] = np.concatenate([cur, arr])
        # pad any column absent from this batch
        total = self.columns["_id"].size
        for name, cur in self.columns.items():
            if cur.size < total:
                self.columns[name] = np.concatenate(
                    [cur, np.zeros(total - cur.size, dtype=cur.dtype)])

    def filtered(self, ids: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
        if ids is None:
            return dict(self.columns)
        mask = np.isin(self.columns["_id"], ids)
        return {k: v[mask] for k, v in self.columns.items()}


class DataframeStore:
    """All shards' dataframes for one index (reference: index.go:111
    `_dataframe` dirs)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.shards: Dict[int, ShardDataframe] = {}

    def shard(self, shard: int, create: bool = False
              ) -> Optional[ShardDataframe]:
        with self._lock:
            df = self.shards.get(shard)
            if df is None and create:
                df = self.shards[shard] = ShardDataframe(shard)
            return df

    def ingest_json(self, shard: int, columns: Dict[str, list]):
        self.shard(shard, create=True).append(columns)

    def ingest_parquet(self, shard: int, data: bytes):
        import pyarrow.parquet as pq
        table = pq.read_table(io.BytesIO(data))
        self.ingest_json(shard, {name: table.column(name).to_pylist()
                                 for name in table.column_names})

    def column_names(self) -> List[str]:
        names: List[str] = []
        with self._lock:
            for df in self.shards.values():
                for n in df.columns:
                    if n not in names:
                        names.append(n)
        return names

    # -- persistence (reference: per-shard `_dataframe` dirs of parquet/
    # arrow files alongside the bitmaps, index.go:111, arrow.go) ----------

    def shard_parquet(self, shard: int) -> Optional[bytes]:
        """One shard's columns as parquet bytes (None when empty)."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        df = self.shard(shard)
        if df is None or df.columns["_id"].size == 0:
            return None
        table = pa.table({k: pa.array(v) for k, v in df.columns.items()})
        buf = io.BytesIO()
        pq.write_table(table, buf)
        return buf.getvalue()

    def save(self, directory: str):
        """Write every shard as <directory>/<shard>.parquet."""
        import os
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            shard_ids = list(self.shards)
        for s in shard_ids:
            data = self.shard_parquet(s)
            if data:
                with open(os.path.join(directory, f"{s}.parquet"),
                          "wb") as fh:
                    fh.write(data)

    @classmethod
    def load(cls, directory: str) -> "DataframeStore":
        """Restore from a save() directory (missing dir -> empty store)."""
        import os
        st = cls()
        if not os.path.isdir(directory):
            return st
        for fn in os.listdir(directory):
            if not fn.endswith(".parquet"):
                continue
            with open(os.path.join(directory, fn), "rb") as fh:
                st.ingest_parquet(int(fn[:-8]), fh.read())
        return st
