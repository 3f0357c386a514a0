"""Roaring-payload-compatible bulk import.

Own copy of featurebase_tpu/ingest/roaring_import.py.  Mirrors the reference's shard-transactional import endpoints (reference:
api.go:618 ImportRoaring, 1647 ImportRoaringShard; fragment.go:2053
ImportRoaringClearAndSet, 2087 ImportRoaringBSI) so the reference's own
`batch`/IDK clients can feed this engine: payloads are pilosa-roaring bytes
whose 64-bit bit-space is `row * SHARD_WIDTH + col` per fragment.

Container key mapping: key = pos >> 16, so row = key >> 4 and the container's
word offset within the row tile is (key & 15) * 2048 (SHARD_WIDTH/2^16 = 16
containers per row, reference fragment.go:45 shardVsContainerExponent).

Imported words land in the fragments' host masters through
merge_row_words/write_row_words, which bump each fragment's seqlock
generation and mark its slots dirty: every device mirror, stacked leaf and
rank cache keyed by those generations follows the import.  The API holds
the index's writers' gate around each call (server/api.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from featurebase_tpu_torch.core.consts import (BSI_OFFSET, CONTAINERS_PER_ROW,
                                               WORDS_PER_ROW)
from featurebase_tpu_torch.model.index import Index
from featurebase_tpu_torch.native import roaring

_WORDS_PER_CONTAINER = roaring.WORDS_PER_CONTAINER


def rows_from_payload(data: bytes) -> Dict[int, np.ndarray]:
    """Decode a fragment payload into {row_id: dense (W,) uint32 words}."""
    keys, words = roaring.decode(data)
    out: Dict[int, np.ndarray] = {}
    for i in range(len(keys)):
        key = int(keys[i])
        row = key >> 4
        ci = key & 15
        tgt = out.get(row)
        if tgt is None:
            tgt = np.zeros(WORDS_PER_ROW, dtype=np.uint32)
            out[row] = tgt
        lo = ci * _WORDS_PER_CONTAINER
        np.bitwise_or(tgt[lo: lo + _WORDS_PER_CONTAINER], words[i],
                      out=tgt[lo: lo + _WORDS_PER_CONTAINER])
    return out


def payload_from_rows(rows: Dict[int, np.ndarray]) -> bytes:
    """{row_id: dense words} -> pilosa-roaring payload (for export/backup)."""
    keys = []
    conts = []
    for row in sorted(rows):
        w = rows[row]
        for ci in range(CONTAINERS_PER_ROW):
            lo = ci * _WORDS_PER_CONTAINER
            chunk = w[lo: lo + _WORDS_PER_CONTAINER]
            if chunk.any():
                keys.append((row << 4) | ci)
                conts.append(chunk)
    if not keys:
        return b""
    return roaring.encode(np.array(keys, dtype=np.uint64), np.stack(conts))


def _update_bit_depth(f, view: str, rows) -> None:
    """BSI payloads can carry more magnitude slices than the field has seen
    (reference: ImportRoaringBSI fragment.go:2087 tracks bit depth)."""
    if view.startswith("bsig_") and rows:
        max_row = max(rows)
        if max_row >= BSI_OFFSET:
            f.bit_depth = max(f.bit_depth, max_row - BSI_OFFSET + 1)


def import_roaring(index: Index, field_name: str, shard: int, data: bytes,
                   view: str = "standard", clear: bool = False,
                   update_existence: bool = True):
    """Merge (or clear) a roaring payload into one fragment (reference
    api.ImportRoaring api.go:618 -> fragment.importRoaring fragment.go:2038).
    """
    f = index.field(field_name)
    if f is None:
        raise ValueError(f"field not found: {field_name}")
    rows = rows_from_payload(data)
    frag = f.create_view_if_not_exists(view).create_fragment_if_not_exists(shard)
    _update_bit_depth(f, view, rows)
    cols_mask = np.zeros(WORDS_PER_ROW, dtype=np.uint32) if update_existence \
        else None
    for row, words in rows.items():
        frag.merge_row_words(row, words, clear=clear)
        if cols_mask is not None and not clear:
            np.bitwise_or(cols_mask, words, out=cols_mask)
    if cols_mask is not None and not clear and cols_mask.any() and \
            index.options.track_existence:
        ef = index.existence_field()
        efrag = ef.standard_view().create_fragment_if_not_exists(shard)
        efrag.merge_row_words(0, cols_mask)


def import_roaring_shard(index: Index, shard: int,
                         views: Dict[str, Dict[str, object]],
                         suppress_existence: bool = False):
    """Transactional multi-view import for one shard (reference
    api.ImportRoaringShard api.go:1647).

    `views` maps "<field>/<view>" (view defaults to standard when omitted:
    "<field>") to {"data": bytes, "clear": bool}.  ClearAndSet semantics per
    view: rows present in the payload replace the stored rows' imported
    containers (reference ImportRoaringClearAndSet fragment.go:2053 — we OR
    by default and replace when "replace" flag set).
    """
    for spec, payload in views.items():
        if "/" in spec:
            field_name, view = spec.split("/", 1)
        else:
            field_name, view = spec, "standard"
        f = index.field(field_name)
        if f is None:
            raise ValueError(f"field not found: {field_name}")
        data = payload.get("data", b"")
        clear = bool(payload.get("clear", False))
        replace = bool(payload.get("replace", False))
        if view == "bsig":
            view = f"bsig_{field_name}"
        rows = rows_from_payload(data)
        frag = f.create_view_if_not_exists(view) \
                .create_fragment_if_not_exists(shard)
        _update_bit_depth(f, view, rows)
        cols_mask = np.zeros(WORDS_PER_ROW, dtype=np.uint32)
        for row, words in rows.items():
            if replace:
                frag.write_row_words(row, words)
            else:
                frag.merge_row_words(row, words, clear=clear)
            if not clear:
                np.bitwise_or(cols_mask, words, out=cols_mask)
        if not suppress_existence and not clear and cols_mask.any() and \
                index.options.track_existence and \
                field_name != "_exists":
            ef = index.existence_field()
            efrag = ef.standard_view().create_fragment_if_not_exists(shard)
            efrag.merge_row_words(0, cols_mask)


def export_roaring(index: Index, field_name: str, shard: int,
                   view: str = "standard") -> bytes:
    """Serialize one fragment to a reference-compatible payload (reference
    fragment.WriteTo:2285 / /export endpoint)."""
    f = index.field(field_name)
    if f is None:
        raise ValueError(f"field not found: {field_name}")
    v = f.view(view)
    frag = v.fragment(shard) if v else None
    if frag is None:
        return b""
    rows = {}
    for r in frag.row_ids():
        words = frag.host_row(int(r))
        if words.any():
            rows[int(r)] = words
    return payload_from_rows(rows)
