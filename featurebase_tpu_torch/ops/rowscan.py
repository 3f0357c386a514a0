"""Row-scan framework: Rows' filter stack over dense tiles.

Own copy of featurebase_tpu/ops/rowscan.py, the dense-tile redesign of the
reference's BitmapFilter visitor machinery (reference: roaring/filter.go:30-226
BitmapFilter with ConsiderKey/ConsiderData, the filters BitmapColumnFilter,
BitmapRowsFilter and BitmapRowLimitFilter; driven by fragment.rows
fragment.go:2465,2522 and executeRowsShard executor.go:4077).

A scan is one declarative spec evaluated in two stages:

  1. host stage: row-id predicates prune the candidate list (whitelist/in,
     previous, max, like-matched ids) — the ConsiderKey role;
  2. device stage: the data predicate over the candidate tile of a shard —
     a column bit-test on the host words, or non-empty (under an optional
     filter) by per-row popcounts with kernel B (ops/cuda_kernels.py
     ``row_counts``) — the ConsiderData role.

Limit applies after both stages (BitmapRowLimitFilter ordering).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Set

import torch

from featurebase_tpu_torch.ops import bitwise as bw


@dataclass
class RowScanSpec:
    """Declarative row filter stack (one instance = one filter chain)."""

    column: Optional[int] = None          # rows containing this column
    whitelist: Optional[Set[int]] = None  # in= (BitmapRowsFilter)
    min_row_excl: Optional[int] = None    # previous= (rows strictly after)
    max_row: Optional[int] = None
    like_ids: Optional[Set[int]] = None   # translate-store LIKE pushdown
    filter_words: Optional[torch.Tensor] = None  # (W,) rows must intersect
    limit: Optional[int] = None           # BitmapRowLimitFilter


def host_prune(row_ids: Sequence[int], spec: RowScanSpec) -> List[int]:
    """Stage 1: key-level pruning (the ConsiderKey role)."""
    out = [int(r) for r in row_ids]
    if spec.min_row_excl is not None:
        out = [r for r in out if r > spec.min_row_excl]
    if spec.max_row is not None:
        out = [r for r in out if r <= spec.max_row]
    if spec.whitelist is not None:
        out = [r for r in out if r in spec.whitelist]
    if spec.like_ids is not None:
        out = [r for r in out if r in spec.like_ids]
    return out


def scan_fragments(frags, spec: RowScanSpec, device) -> List[int]:
    """Scan one or more fragments (views OR-ed) of one shard: the sorted row
    ids passing the whole filter stack.  The candidate rows gather from the
    fragments' device mirrors on `device` into one tile, counted by one
    kernel-B launch (with the filter words, if any)."""
    frags = [f for f in frags if f is not None]
    if not frags:
        return []
    cand = sorted({r for f in frags for r in map(int, f.row_ids())})
    cand = host_prune(cand, spec)
    if not cand:
        return []

    if spec.column is not None:
        col = int(spec.column)
        keep = [r for r in cand if any(f.get_bit(r, col) for f in frags)]
        return keep[: spec.limit] if spec.limit is not None else keep

    # data predicate: row non-empty (optionally under a filter bitmap)
    acc = None
    for f in frags:
        tile, _ = f.device_rows(cand, device)
        acc = tile if acc is None else bw.b_or(acc, tile)
    if spec.filter_words is not None:
        pc = bw.count_and_rows(acc, spec.filter_words)
    else:
        pc = bw.popcount_rows(acc)
    out = [r for r, c in zip(cand, pc.cpu().tolist()) if c > 0]
    if spec.limit is not None:
        out = out[: int(spec.limit)]
    return out
