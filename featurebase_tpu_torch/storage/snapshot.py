"""Holder snapshot and restore, in the JAX package's format.

Own copy of featurebase_tpu/storage/snapshot.py (reference: rbf/db.go:264
checkpoint; ctl/backup.go:87 backup of schema, translate stores, shards and
idalloc).  Each package loads the other's snapshots.  Layout:

  <dir>/schema.json                         index/field schema
  <dir>/views.json                          SQL views (when any)
  <dir>/sqlmeta.json                        SQL databases and functions
  <dir>/translate/<index>.json              column-key store
  <dir>/translate/<index>.<field>.json      row-key stores
  <dir>/idalloc.json                        ID allocator state
  <dir>/fragments/<index>/<field>/<view>/<shard>.npz   dense rows
  <dir>/dataframe/<index>/<shard>.parquet   dataframe side-store

npz fragments hold {rows: (N,) int64, words: (N, W) uint32} and load directly
into Fragment host masters, so both engines answer over identical bits.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np

from featurebase_tpu_torch.model.fragment import Fragment
from featurebase_tpu_torch.model.index import Holder
from featurebase_tpu_torch.storage.translate import (FieldTranslateStore,
                                                     IndexTranslateStore)


def save(holder: Holder, directory: str, idalloc=None):
    """Write a complete snapshot (atomic: staged to a temporary directory
    beside `directory`, then renamed over it)."""
    parent = os.path.dirname(os.path.abspath(directory)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".snapshot-", dir=parent)
    try:
        with open(os.path.join(tmp, "schema.json"), "w") as fh:
            json.dump(holder.schema(), fh)
        if holder.sql_views:
            with open(os.path.join(tmp, "views.json"), "w") as fh:
                json.dump(holder.sql_views, fh)
        if holder.sql_databases or holder.sql_functions:
            with open(os.path.join(tmp, "sqlmeta.json"), "w") as fh:
                json.dump({"databases": holder.sql_databases,
                           "functions": holder.sql_functions}, fh)
        tdir = os.path.join(tmp, "translate")
        os.makedirs(tdir, exist_ok=True)
        for iname, idx in holder.indexes.items():
            with open(os.path.join(tdir, f"{iname}.json"), "w") as fh:
                json.dump(idx.translate_store.to_json(), fh)
            for fname, store in idx.field_translate_stores.items():
                with open(os.path.join(tdir, f"{iname}.{fname}.json"),
                          "w") as fh:
                    json.dump(store.to_json(), fh)
        if idalloc is not None:
            with open(os.path.join(tmp, "idalloc.json"), "w") as fh:
                json.dump(idalloc.to_json(), fh)
        for iname, idx in holder.indexes.items():
            for (fname, vname, shard), frag in idx.iter_fragments():
                if frag.num_rows == 0:
                    continue
                d = frag.to_npz_dict()
                if not d["words"].any():
                    continue
                fdir = os.path.join(tmp, "fragments", iname, fname, vname)
                os.makedirs(fdir, exist_ok=True)
                np.savez_compressed(os.path.join(fdir, f"{shard}.npz"), **d)
        for iname, idx in holder.indexes.items():
            if idx._dataframe is not None and idx._dataframe.shards:
                idx._dataframe.save(os.path.join(tmp, "dataframe", iname))
        if os.path.exists(directory):
            old = directory + ".old"
            if os.path.exists(old):
                shutil.rmtree(old)
            os.rename(directory, old)
            os.rename(tmp, directory)
            shutil.rmtree(old)
        else:
            os.rename(tmp, directory)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def load(directory: str, idalloc=None) -> Holder:
    """Restore a Holder (schema, SQL catalogue, translate stores, fragments,
    BSI depth, dataframes) and, given `idalloc`, the ID allocator."""
    holder = Holder(directory)
    schema_path = os.path.join(directory, "schema.json")
    if not os.path.exists(schema_path):
        return holder
    with open(schema_path) as fh:
        holder.apply_schema(json.load(fh))
    views_path = os.path.join(directory, "views.json")
    if os.path.exists(views_path):
        with open(views_path) as fh:
            holder.sql_views = json.load(fh)
    meta_path = os.path.join(directory, "sqlmeta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as fh:
            meta = json.load(fh)
        holder.sql_databases = meta.get("databases", {})
        holder.sql_functions = meta.get("functions", {})
    tdir = os.path.join(directory, "translate")
    if os.path.isdir(tdir):
        for fn in os.listdir(tdir):
            if not fn.endswith(".json"):
                continue
            stem = fn[:-5]
            with open(os.path.join(tdir, fn)) as fh:
                data = json.load(fh)
            if "." in stem:
                iname, fname = stem.split(".", 1)
                idx = holder.index(iname)
                if idx is not None:
                    idx.field_translate_stores[fname] = \
                        FieldTranslateStore.from_json(iname, fname, data)
            else:
                idx = holder.index(stem)
                if idx is not None:
                    idx.translate_store = IndexTranslateStore.from_json(
                        stem, data)
    ia_path = os.path.join(directory, "idalloc.json")
    if idalloc is not None and os.path.exists(ia_path):
        with open(ia_path) as fh:
            idalloc.restore_json(json.load(fh))
    froot = os.path.join(directory, "fragments")
    if os.path.isdir(froot):
        for iname in os.listdir(froot):
            idx = holder.index(iname)
            if idx is None:
                continue
            for fname in os.listdir(os.path.join(froot, iname)):
                f = idx.field(fname)
                if f is None:
                    continue
                for vname in os.listdir(os.path.join(froot, iname, fname)):
                    _load_view(f, iname, fname, vname,
                               os.path.join(froot, iname, fname, vname))
    dfroot = os.path.join(directory, "dataframe")
    if os.path.isdir(dfroot):
        from featurebase_tpu_torch.model.dataframe import DataframeStore
        for iname in os.listdir(dfroot):
            idx = holder.index(iname)
            if idx is not None:
                idx._dataframe = DataframeStore.load(
                    os.path.join(dfroot, iname))
    return holder


def _load_view(f, iname: str, fname: str, vname: str, vdir: str):
    """One view's fragments; a BSI view restores the field's bit depth from
    the slice rows present (as featurebase_tpu/storage/snapshot.py does)."""
    v = f.create_view_if_not_exists(vname)
    for fn in os.listdir(vdir):
        if not fn.endswith(".npz"):
            continue
        shard = int(fn[:-4])
        with np.load(os.path.join(vdir, fn)) as z:
            v.fragments[shard] = Fragment.from_npz_dict(
                iname, fname, vname, shard,
                {"rows": z["rows"], "words": z["words"]})
    if vname.startswith("bsig_"):
        max_slice = max((int(r) - 2 for fr in v.fragments.values()
                         for r in fr.row_ids()), default=-1)
        if max_slice >= 0:
            f.bit_depth = max(f.bit_depth, max_slice + 1)
