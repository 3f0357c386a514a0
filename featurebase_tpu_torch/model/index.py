"""Index (table) and Holder (root registry).

Own copy of featurebase_tpu/model/index.py (reference index.go:27 Index,
holder.go:58 Holder): fields, translate stores, existence tracking, the
writers' gate, the dataframe side-store, the schema documents and the SQL
catalogue (views, databases, functions) a snapshot keeps.  Deleting a
field or an index also drops every device copy of it (Field.release_device).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from featurebase_tpu_torch.model.field import TYPE_SET, Field, FieldOptions
from featurebase_tpu_torch.storage.translate import (FieldTranslateStore,
                                                     IndexTranslateStore)
from featurebase_tpu_torch.utils.rwlock import ShardedGate

# reference: index.go existenceFieldName = "_exists"
EXISTENCE_FIELD = "_exists"


class IndexOptions:
    def __init__(self, keys: bool = False, track_existence: bool = True):
        self.keys = keys
        self.track_existence = track_existence

    def to_json(self):
        return {"keys": self.keys, "trackExistence": self.track_existence}

    @classmethod
    def from_json(cls, d: dict) -> "IndexOptions":
        return cls(keys=d.get("keys", False),
                   track_existence=d.get("trackExistence", True))


class Index:
    def __init__(self, name: str, options: Optional[IndexOptions] = None):
        self.name = name
        self.options = options or IndexOptions()
        self._lock = threading.RLock()
        # writers hold it shared (utils/rwlock.py); pinned readers never
        # take it
        self.mutate_gate = ShardedGate()
        self.fields: Dict[str, Field] = {}
        self.translate_store = IndexTranslateStore(name)
        self.field_translate_stores: Dict[str, FieldTranslateStore] = {}
        # per-shard columnar side-store (reference index.go:111 `_dataframe`
        # dirs), made at first use
        self._dataframe = None
        if self.options.track_existence:
            self.fields[EXISTENCE_FIELD] = Field(
                name, EXISTENCE_FIELD,
                FieldOptions(type=TYPE_SET, cache_type="none"))

    @property
    def dataframe(self):
        if self._dataframe is None:
            from featurebase_tpu_torch.model.dataframe import DataframeStore
            self._dataframe = DataframeStore()
        return self._dataframe

    # -- fields --------------------------------------------------------------

    def create_field(self, name: str, options: Optional[FieldOptions] = None,
                     if_not_exists: bool = False) -> Field:
        with self._lock:
            if name in self.fields:
                if if_not_exists:
                    return self.fields[name]
                raise ValueError(f"field already exists: {name}")
            f = Field(self.name, name, options or FieldOptions())
            self.fields[name] = f
            if f.options.keys:
                self.field_translate_stores[name] = FieldTranslateStore(
                    self.name, name)
            return f

    def field(self, name: str) -> Optional[Field]:
        return self.fields.get(name)

    def delete_field(self, name: str):
        """Remove a field, its row keys and every device copy of it."""
        with self._lock:
            f = self.fields.pop(name, None)
            self.field_translate_stores.pop(name, None)
        if f is not None:
            f.release_device()

    def existence_field(self) -> Optional[Field]:
        return self.fields.get(EXISTENCE_FIELD)

    def fragment_generations(self, keys=None) -> dict:
        """Fragment seqlock generations by (field, view, shard): of every
        fragment, or with `keys` of exactly those, -1 for a fragment that
        does not exist (JAX index.py:133)."""
        if keys is not None:
            gens = {}
            for key in keys:
                fname, vname, shard = key
                f = self.fields.get(fname)
                v = f.views.get(vname) if f is not None else None
                frag = v.fragments.get(shard) if v is not None else None
                gens[key] = -1 if frag is None else frag.generation
            return gens
        gens = {}
        for fname, f in list(self.fields.items()):
            for vname, v in list(f.views.items()):
                for shard, frag in list(v.fragments.items()):
                    gens[(fname, vname, shard)] = frag.generation
        return gens

    def public_fields(self) -> List[Field]:
        """Every field but the existence field, in declaration order."""
        return [f for n, f in self.fields.items() if n != EXISTENCE_FIELD]

    # -- existence maintenance (reference: fragment importExistenceColumns) --

    def mark_exists(self, cols: np.ndarray):
        if not self.options.track_existence:
            return
        cols = np.asarray(cols, dtype=np.int64)
        if cols.size == 1:
            # a point write (Set) sets one bit: the bulk import's sorts
            # would give up the GIL, and a writer that gives it up and takes
            # it back at once starves a reader thread waiting for it
            self.existence_field().set_bit(0, int(cols[0]))
        elif cols.size:
            self.existence_field().import_bits(
                np.zeros(cols.size, dtype=np.int64), cols)

    def available_shards(self) -> List[int]:
        """Union of shards across fields (reference index.go:498)."""
        shards = set()
        for f in self.fields.values():
            shards.update(f.available_shards())
        return sorted(shards)

    def row_translation(self, field: str) -> Optional[FieldTranslateStore]:
        return self.field_translate_stores.get(field)

    def iter_fragments(self):
        """Yields ((field, view, shard), fragment) for every fragment
        (snapshot pin capture)."""
        for fname, f in list(self.fields.items()):
            for vname, v in list(f.views.items()):
                for shard, frag in list(v.fragments.items()):
                    yield (fname, vname, shard), frag

    def to_info(self):
        return {"name": self.name, "options": self.options.to_json(),
                "fields": [f.to_info() for f in self.public_fields()]}


class Holder:
    """Root object owning all indexes (reference holder.go:58)."""

    def __init__(self, path: str = ""):
        self.path = path
        self._lock = threading.RLock()
        self.indexes: Dict[str, Index] = {}
        # SQL views: name -> SELECT text; databases: name -> options;
        # functions: name -> definition (reference sql3 CREATE VIEW,
        # DATABASE, FUNCTION), kept by snapshots and the WAL
        self.sql_views: Dict[str, str] = {}
        self.sql_databases: Dict[str, dict] = {}
        self.sql_functions: Dict[str, dict] = {}
        # ExternalLookup()'s database adapter (storage/lookup.py; reference
        # holder.lookupDB, executor.go:4358)
        self.lookup_db = None

    def create_index(self, name: str, options: Optional[IndexOptions] = None,
                     if_not_exists: bool = False) -> Index:
        with self._lock:
            if name in self.indexes:
                if if_not_exists:
                    return self.indexes[name]
                raise ValueError(f"index already exists: {name}")
            idx = Index(name, options)
            self.indexes[name] = idx
            return idx

    def index(self, name: str) -> Optional[Index]:
        return self.indexes.get(name)

    def delete_index(self, name: str):
        """Remove an index and every device copy of it."""
        with self._lock:
            idx = self.indexes.pop(name, None)
        if idx is not None:
            for f in list(idx.fields.values()):
                f.release_device()

    def schema(self):
        return [idx.to_info() for _, idx in sorted(self.indexes.items())]

    def apply_schema(self, schema: list):
        """Create indexes/fields from a schema document (reference
        holder.go:836 applySchema)."""
        for idx_info in schema:
            idx = self.create_index(
                idx_info["name"],
                IndexOptions.from_json(idx_info.get("options", {})),
                if_not_exists=True)
            for f_info in idx_info.get("fields", []):
                idx.create_field(
                    f_info["name"],
                    FieldOptions.from_json(f_info.get("options", {})),
                    if_not_exists=True)
