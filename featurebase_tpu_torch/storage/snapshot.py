"""Restore a Holder from a featurebase_tpu snapshot directory.

Reads the layout written by featurebase_tpu/storage/snapshot.py ``save``:

  <dir>/schema.json                         index/field schema
  <dir>/translate/<index>.json              column-key store
  <dir>/translate/<index>.<field>.json      row-key stores
  <dir>/fragments/<index>/<field>/<view>/<shard>.npz   dense rows

npz fragments hold {rows: (N,) int64, words: (N, W) uint32} and load directly
into Fragment host masters, so both engines answer over identical bits.
"""
from __future__ import annotations

import json
import os

import numpy as np

from featurebase_tpu_torch.model.fragment import Fragment
from featurebase_tpu_torch.model.index import Holder
from featurebase_tpu_torch.storage.translate import (FieldTranslateStore,
                                                     IndexTranslateStore)


def load(directory: str) -> Holder:
    """Restore a Holder (schema, translate stores, fragments, BSI depth)."""
    holder = Holder(directory)
    schema_path = os.path.join(directory, "schema.json")
    if not os.path.exists(schema_path):
        return holder
    with open(schema_path) as fh:
        holder.apply_schema(json.load(fh))
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
    froot = os.path.join(directory, "fragments")
    if not os.path.isdir(froot):
        return holder
    for iname in os.listdir(froot):
        idx = holder.index(iname)
        if idx is None:
            continue
        for fname in os.listdir(os.path.join(froot, iname)):
            f = idx.field(fname)
            if f is None:
                continue
            for vname in os.listdir(os.path.join(froot, iname, fname)):
                v = f.create_view_if_not_exists(vname)
                vdir = os.path.join(froot, iname, fname, vname)
                for fn in os.listdir(vdir):
                    if not fn.endswith(".npz"):
                        continue
                    shard = int(fn[:-4])
                    with np.load(os.path.join(vdir, fn)) as z:
                        v.fragments[shard] = Fragment.from_npz_dict(
                            iname, fname, vname, shard,
                            {"rows": z["rows"], "words": z["words"]})
                # restore BSI bit depth from the slice rows present
                # (as featurebase_tpu/storage/snapshot.py does on load)
                if vname.startswith("bsig_"):
                    max_slice = max((int(r) - 2 for fr in v.fragments.values()
                                     for r in fr.row_ids()), default=-1)
                    if max_slice >= 0:
                        f.bit_depth = max(f.bit_depth, max_slice + 1)
    return holder
