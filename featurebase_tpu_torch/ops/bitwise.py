"""Bitwise set algebra and popcounts over dense bitmap tiles (PyTorch).

Counterpart of featurebase_tpu/ops/bitwise.py.  Words are ``torch.int32``
tensors holding the uint32 bit patterns of the host masters (moved across by
``ndarray.view(np.int32)``, no copy); counts are int64.  The elementwise
combinators, ``b_shift`` and GroupBy's mask products (``all_pairs_and``,
``stacked_all_pairs_and``, ``stacked_mask_filter``, ``and_pairs_gather``)
are plain torch, as are ``or_reduce_rows`` and ``any_set``.  Every popcount
reduction goes through the kernels of ops/cuda_kernels.py: totals through
``plan_eval`` (kernel A), per-row counts through ``row_counts`` (kernel B),
pair counts through ``pair_counts`` (kernel E).  On CPU tensors those
wrappers run their plain versions.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import SHARD_WIDTH, WORD_BITS
from featurebase_tpu_torch.ops import cuda_kernels as ck

# ---------------------------------------------------------------------------
# Elementwise combinators
# ---------------------------------------------------------------------------


def b_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def b_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def b_xor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a ^ b


def b_andnot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a AND NOT b (reference Difference, roaring.go:1179)."""
    return a & ~b


def b_not(a: torch.Tensor) -> torch.Tensor:
    """Full complement over the shard universe (callers AND with an
    existence row themselves, as in the JAX package)."""
    return ~a


# ---------------------------------------------------------------------------
# Popcount reductions (kernels A and B)
# ---------------------------------------------------------------------------

def _flat_program(*arrays: torch.Tensor) -> ck.ProgramBuilder:
    n = arrays[0].numel()
    pb = ck.ProgramBuilder(1, n)
    for i, a in enumerate(arrays):
        pb.plane(i, a.reshape(1, n))
    return pb


def popcount(a: torch.Tensor) -> torch.Tensor:
    """Total set-bit count over every axis -> int64 scalar tensor."""
    if a.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=a.device)
    pb = _flat_program(a)
    _, counts = ck.plan_eval(pb.build(pb.load(0)), want_words=False,
                             want_counts=True)
    return counts[0]


def count_and(a: torch.Tensor, b: torch.Tensor,
              acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused popcount(a & b) + acc -> int64 scalar tensor (counterpart of
    pallas_kernels.count_and_pallas; `acc` is any one-element tensor)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        total = torch.zeros((), dtype=torch.int64, device=a.device)
    else:
        pb = _flat_program(a, b)
        r = pb.op(ck.OP_AND, pb.load(0), pb.load(1))
        _, counts = ck.plan_eval(pb.build(r), want_words=False,
                                 want_counts=True)
        total = counts[0]
    if acc is not None:
        total = total + acc.reshape(()).to(torch.int64)
    return total


def popcount_rows(a: torch.Tensor) -> torch.Tensor:
    """Per-row popcount over the trailing word axis -> (...,) int64."""
    lead = a.shape[:-1]
    out = ck.row_counts(a.reshape(1, -1, a.shape[-1]).contiguous())
    return out.reshape(lead)


def count_and_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(R, W) & (1, W) or (W,) filter -> (R,) int64 per-row counts."""
    if a.dim() != 2:
        raise ValueError(f"count_and_rows takes an (R, W) tile, got "
                         f"{tuple(a.shape)}")
    filt = b.reshape(1, a.shape[-1]).contiguous()
    return ck.row_counts(a[None].contiguous(), filt)[0]


def per_shard_row_counts(tiles: torch.Tensor) -> torch.Tensor:
    """(S, R, W) -> (S, R) int64 per-shard per-row popcounts."""
    return ck.row_counts(tiles.contiguous())


def per_shard_filtered_row_counts(tiles: torch.Tensor, filt: torch.Tensor
                                  ) -> torch.Tensor:
    """(S, R, W) x (S, W) -> (S, R) int64."""
    return ck.row_counts(tiles.contiguous(), filt.contiguous())


def any_set(a: torch.Tensor) -> bool:
    """True if any bit is set."""
    return bool((a != 0).any())


def or_reduce_rows(tile: torch.Tensor) -> torch.Tensor:
    """OR of an (R, W) tile's rows -> (W,) (n-way union, reference
    roaring.go:1410), as a tree of halvings; zeros for R = 0."""
    if tile.shape[0] == 0:
        return torch.zeros(tile.shape[-1], dtype=tile.dtype,
                           device=tile.device)
    while tile.shape[0] > 1:
        half = tile.shape[0] // 2
        top = tile[:half] | tile[half:2 * half]
        tile = torch.cat([top, tile[2 * half:]]) if tile.shape[0] % 2 \
            else top
    return tile[0]


# -- stacked (S, ...) counts: one launch over every shard (bitwise.py:144-180)

def stacked_row_counts(tiles: torch.Tensor) -> torch.Tensor:
    """(S, R, W) -> (R,) int64 per-row popcounts summed over the shards."""
    return ck.row_counts(tiles.contiguous()).sum(0)


def stacked_filtered_row_counts(tiles: torch.Tensor, filt: torch.Tensor
                                ) -> torch.Tensor:
    """(S, R, W) x (S, W) -> (R,) int64."""
    return ck.row_counts(tiles.contiguous(), filt.contiguous()).sum(0)


def count_and_pairs(masks: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """All-pairs intersection counts (F, W) x (R, W) -> (F, R) int64, the
    GroupBy cross-product inner op (reference groupByIterator
    executor.go:8617): kernel E at S = 1."""
    return ck.pair_counts(masks[None].contiguous(), tile[None].contiguous())


def stacked_pair_counts(masks: torch.Tensor, tile: torch.Tensor,
                        filt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, F, W) x (S, R, W) [& (S, W) filter] -> (F, R) int64 (kernel E;
    the filter is stacked_mask_filter fused)."""
    return ck.pair_counts(masks.contiguous(), tile.contiguous(),
                          None if filt is None else filt.contiguous())


def stacked_mask_filter(tiles: torch.Tensor, filt: torch.Tensor
                        ) -> torch.Tensor:
    """(S, R, W) & (S, W) -> (S, R, W)."""
    return tiles & filt[:, None, :]


def all_pairs_and(masks: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
    """Every cross-product mask: (F, W) x (R, W) -> (F * R, W), the R index
    fastest (itertools.product order)."""
    return (masks[:, None, :] & tile[None, :, :]).reshape(-1, masks.shape[-1])


def stacked_all_pairs_and(masks: torch.Tensor, tile: torch.Tensor
                          ) -> torch.Tensor:
    """(S, F, W) x (S, R, W) -> (S, F * R, W), R fastest."""
    S, F, W = masks.shape
    return (masks[:, :, None, :] & tile[:, None, :, :]).reshape(
        S, F * tile.shape[1], W)


def and_pairs_gather(masks: torch.Tensor, tile: torch.Tensor,
                     fi: torch.Tensor, rj: torch.Tensor) -> torch.Tensor:
    """The surviving cross-product masks masks[fi] & tile[rj] -> (K, W)."""
    return masks.index_select(0, fi) & tile.index_select(0, rj)


# ---------------------------------------------------------------------------
# Shift (reference: executor.go:5818 executeShiftShard, row.go Shift)
# ---------------------------------------------------------------------------

def b_shift(a: torch.Tensor, n: int = 1) -> torch.Tensor:
    """Shift every set bit's column up by n within its row (bits shifted past
    the end are dropped).  int32 `>>` is arithmetic, so the carry is masked
    to a logical shift."""
    if n == 0:
        return a
    word_shift, bit_shift = n // WORD_BITS, n % WORD_BITS
    if word_shift:
        a = torch.roll(a, word_shift, dims=-1)
        a[..., :word_shift] = 0
    if bit_shift:
        carry = (a >> (WORD_BITS - bit_shift)) & ((1 << bit_shift) - 1)
        carry = torch.roll(carry, 1, dims=-1)
        carry[..., :1] = 0
        a = (a << bit_shift) | carry
    return a


# ---------------------------------------------------------------------------
# Host helpers (numpy; own copies of featurebase_tpu/ops/bitwise.py:261-333,
# numpy branch only)
# ---------------------------------------------------------------------------

def range_mask(start: int, stop: int, width: int = SHARD_WIDTH) -> np.ndarray:
    """Dense mask with bits [start, stop) set, as a (width/32,) uint32
    vector."""
    w = width // WORD_BITS
    out = np.zeros(w, dtype=np.uint32)
    if stop <= start:
        return out
    start = max(start, 0)
    stop = min(stop, width)
    sw, ew = start // WORD_BITS, (stop - 1) // WORD_BITS
    if sw == ew:
        bits = 0
        for b in range(start % WORD_BITS, ((stop - 1) % WORD_BITS) + 1):
            bits |= (1 << b)
        out[sw] = bits
    else:
        out[sw] = (0xFFFFFFFF << (start % WORD_BITS)) & 0xFFFFFFFF
        out[sw + 1:ew] = 0xFFFFFFFF
        out[ew] = 0xFFFFFFFF >> (WORD_BITS - 1 - ((stop - 1) % WORD_BITS))
    return out


def words_to_cols(words, base: int = 0) -> np.ndarray:
    """Decode dense uint32 words into a sorted uint64 array of set columns
    (bit i of word k is column 32 k + i; words are little-endian), with
    the C++ ctz decode of native/bitops.cpp (the host analog of
    roaring.Bitmap.Slice, roaring/roaring.go:573;
    featurebase_tpu/ops/bitwise.py:289)."""
    from featurebase_tpu_torch.native import bitops
    return bitops.words_to_cols(np.asarray(words).view(np.uint32), base)


def cols_to_words(cols, width: int = SHARD_WIDTH) -> np.ndarray:
    """Encode column ids (< width) into a dense uint32 word vector (the
    C++ scatter of native/bitops.cpp)."""
    from featurebase_tpu_torch.native import bitops
    return bitops.cols_to_words(np.asarray(cols, dtype=np.int64),
                                width // WORD_BITS)


def words_to_cols_plain(words, base: int = 0) -> np.ndarray:
    """numpy version of words_to_cols."""
    flat = np.ascontiguousarray(np.asarray(words).view(np.uint32)).reshape(-1)
    bits = np.unpackbits(flat.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint64) + np.uint64(base)


def cols_to_words_plain(cols, width: int = SHARD_WIDTH) -> np.ndarray:
    """numpy version of cols_to_words (columns must lie in [0, width))."""
    c = np.asarray(cols, dtype=np.int64)
    out = np.zeros(width // WORD_BITS, dtype=np.uint32)
    if c.size == 0:
        return out
    np.bitwise_or.at(out, c >> 5, np.uint32(1) << (c & 31).astype(np.uint32))
    return out
