"""Row: a query-result bitmap over the full column space, segmented by shard.

Counterpart of featurebase_tpu/model/row.py (reference row.go:15 Row,
row.go:511 RowSegment, segment ops row.go:546-629), and SignedRow, the
result of Distinct over a BSI field.  Each segment is a
(WORDS_PER_ROW,) int32 torch tensor on the executor's device (``from_columns``
builds CPU segments); the set algebra runs segment by segment with torch
ops, on the left operand's device; ``columns()`` and ``count()`` decode
through host numpy.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import SHARD_WIDTH
from featurebase_tpu_torch.ops import bitwise as bw


def host_words(seg: torch.Tensor) -> np.ndarray:
    """uint32 host copy of int32 device words."""
    return seg.cpu().numpy().view(np.uint32)


class Row:
    __slots__ = ("segments", "keys")

    def __init__(self, segments: Optional[Dict[int, torch.Tensor]] = None,
                 keys: Optional[List[str]] = None):
        # shard -> (W,) int32 tensor
        self.segments: Dict[int, torch.Tensor] = segments or {}
        self.keys = keys  # set after key translation of results

    @classmethod
    def from_columns(cls, cols: Iterable[int]) -> "Row":
        """Host (CPU) segments for the given absolute column ids."""
        cols = np.asarray(list(cols) if not isinstance(cols, np.ndarray)
                          else cols, dtype=np.int64)
        segs: Dict[int, torch.Tensor] = {}
        if cols.size:
            shards = cols >> 20
            for s in np.unique(shards):
                words = bw.cols_to_words(cols[shards == s] % SHARD_WIDTH)
                segs[int(s)] = torch.from_numpy(words.view(np.int32))
        return cls(segs)

    # -- set algebra (reference row.go:202 Merge/Union etc.) ----------------

    def _binary(self, other: "Row", fn, keep_left: bool = True,
                keep_right: bool = True) -> "Row":
        out: Dict[int, torch.Tensor] = {}
        for s in set(self.segments) | set(other.segments):
            a, b = self.segments.get(s), other.segments.get(s)
            if a is None and not keep_right or b is None and not keep_left:
                continue
            if a is None:
                a = torch.zeros_like(b)
            elif b is None:
                b = torch.zeros_like(a)
            out[s] = fn(a, b.to(a.device))
        return Row(out)

    def union(self, other: "Row") -> "Row":
        return self._binary(other, bw.b_or)

    def intersect(self, other: "Row") -> "Row":
        return self._binary(other, bw.b_and, keep_left=False,
                            keep_right=False)

    def difference(self, other: "Row") -> "Row":
        return self._binary(other, bw.b_andnot, keep_right=False)

    def xor(self, other: "Row") -> "Row":
        return self._binary(other, bw.b_xor)

    def any(self) -> bool:
        return any(bw.any_set(a) for a in self.segments.values())

    def includes(self, col: int) -> bool:
        seg = self.segments.get(col >> 20)
        if seg is None:
            return False
        c = col % SHARD_WIDTH
        return bool((host_words(seg[c >> 5])[()] >> (c & 31)) & 1)

    def segment(self, shard: int) -> Optional[torch.Tensor]:
        """The words of one shard, or None."""
        return self.segments.get(shard)

    def _host(self) -> np.ndarray:
        """(n_segments, W) uint32 host words in shard order (one copy).  A
        cluster's merged row may hold device segments beside a peer's host
        ones; they stack on the first segment's device."""
        segs = [self.segments[s] for s in sorted(self.segments)]
        return host_words(torch.stack([g.to(segs[0].device) for g in segs]))

    def count(self) -> int:
        if not self.segments:
            return 0
        return int(np.bitwise_count(self._host()).sum())

    def columns(self) -> np.ndarray:
        """Sorted absolute column ids (host decode)."""
        if not self.segments:
            return np.empty(0, dtype=np.uint64)
        host = self._host()
        return np.concatenate([
            bw.words_to_cols(host[i], base=s * SHARD_WIDTH)
            for i, s in enumerate(sorted(self.segments))])

    def to_json(self):
        if self.keys is not None:
            return {"keys": list(self.keys)}
        return {"columns": self.columns().tolist()}

    def __eq__(self, other):
        if not isinstance(other, Row):
            return NotImplemented
        return np.array_equal(self.columns(), other.columns())

    def __repr__(self):
        cols = self.columns()
        preview = ", ".join(str(int(c)) for c in cols[:8])
        return (f"Row<{cols.size} cols: "
                f"[{preview}{'...' if cols.size > 8 else ''}]>")


class SignedRow:
    """Distinct values of a BSI field as two bitmaps: the magnitudes of the
    negative values and the non-negative values (reference SignedRow,
    executor.go Distinct over BSI; featurebase_tpu/model/row.py:137)."""

    __slots__ = ("neg", "pos", "field")

    def __init__(self, neg: Row, pos: Row, field: Optional[str] = None):
        self.neg = neg
        self.pos = pos
        self.field = field

    def values(self) -> np.ndarray:
        """Sorted distinct signed values."""
        n = -self.neg.columns().astype(np.int64)
        p = self.pos.columns().astype(np.int64)
        return np.unique(np.concatenate([n, p]))

    def union(self, other: "SignedRow") -> "SignedRow":
        return SignedRow(self.neg.union(other.neg), self.pos.union(other.pos),
                         self.field or other.field)

    def to_json(self):
        return {"values": [int(v) for v in self.values()]}
