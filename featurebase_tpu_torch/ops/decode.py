"""Decoded BSI values: the plain versions of kernels G, G' and I, the host
decode past depth 31, Sort's stacked ops and the Percentile bisection.

Counterpart of the dense-value half of featurebase_tpu/ops/bsi.py.  A
stacked group is an (S, D + 2, W) int32 tensor (plane 0 exists, plane 1
sign, plane 2 + i magnitude bit i); values are sign and magnitude relative
to the field's base, and column c of a shard is bit c & 31 of word c >> 5.

- ``expand_bits`` (bsi.py:281) and ``pack_bits`` (:706): words to one
  uint8 a column and back, as torch ops.
- ``decode_values_plain`` (the plain kernel G''; ``decode_values``
  :759, ``decode_values_jit`` :482), ``decode_gather_plain`` (kernel G''';
  ``decode_gather`` :367) and ``percentile_counts_plain`` (kernel I; the
  counting passes of ``percentile_fused`` :491-607).  The wrappers in
  ops/cuda_kernels.py run these on CPU tensors and the kernels on CUDA
  tensors.
- ``decode_values_host`` (:289) and ``expand_bits_host`` (:325): the
  numpy decode of any depth up to 62, in int64.
- ``sort_stacked`` (``sort_bsi_stacked`` :661, ``_sort_core`` :636) and
  ``after_mask_stacked`` (:716): every shard's top-`cut` order and the
  keyset cursor's mask, as torch ops.  Ties go to the lower column through
  an int64 key that holds the column, not through any order top-k keeps.
- ``percentile``: the reference's bisection (executor.go:1310) over kernel
  I's histograms, with ``percentile_fused``'s exact rational thresholds.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import WORD_BITS
from featurebase_tpu_torch.ops import cuda_kernels as ck

# the deepest group the int32 decode takes (bsi.py:759); deeper ones decode
# on the host in int64, up to HOST_MAX_DEPTH
DEVICE_MAX_DEPTH = ck.MAX_DECODE_DEPTH
HOST_MAX_DEPTH = 62
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def expand_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., 32 W) uint8, element c bit c."""
    bits = (words[..., None] >> _shifts(words.device)) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.uint8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., C) bool -> (..., C / 32) int32 words (inverse of
    expand_bits)."""
    x = bits.reshape(*bits.shape[:-1], -1, WORD_BITS).to(torch.int64)
    w = (x << _shifts(bits.device).to(torch.int64)).sum(-1)
    return torch.where(w > INT32_MAX, w - (1 << 32), w).to(torch.int32)


# ---------------------------------------------------------------------------
# Plain versions of kernels G, G' and I
# ---------------------------------------------------------------------------

def decode_values_plain(group: torch.Tensor) -> torch.Tensor:
    """(..., D + 2, W) group -> (..., 32 W) int32 values: the magnitude
    planes summed in int32, negated where the sign bit is set."""
    D = group.shape[-2] - 2
    acc = torch.zeros((*group.shape[:-2], group.shape[-1] * WORD_BITS),
                      dtype=torch.int32, device=group.device)
    for i in range(D):
        acc += expand_bits(group[..., 2 + i, :]).to(torch.int32) << i
    return torch.where(expand_bits(group[..., 1, :]) == 1, -acc, acc)


def decode_gather_plain(group: torch.Tensor, cols: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(D + 2, W) group, (N,) columns -> (vals (N,) int32, ok (N,) int32)."""
    c = cols.to(torch.int64)
    bits = (group[:, c >> 5] >> (c & 31).to(torch.int32)) & 1   # (D + 2, N)
    mag = torch.zeros(c.shape, dtype=torch.int32, device=group.device)
    for i in range(group.shape[0] - 2):
        mag |= bits[2 + i] << i
    return torch.where(bits[1] == 1, -mag, mag), bits[0].clone()


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 modulo 2^32 (the kernel's int32 add)."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def percentile_counts_plain(vals: torch.Tensor, exists: torch.Tensor,
                            filt: torch.Tensor, base: int,
                            thresholds: Sequence[int]) -> torch.Tensor:
    """Kernel I's function with torch ops: (2K + 3,) int64 bins, min, max
    (ops/cuda_kernels.py percentile_counts)."""
    present = expand_bits(exists & filt).bool()
    x = _wrap_int32(vals[present].to(torch.int64) + int(base)).to(torch.int64)
    K = len(thresholds)
    t = torch.tensor(list(thresholds), dtype=torch.int64, device=vals.device)
    k = torch.searchsorted(t, x) if K else torch.zeros_like(x)
    eq = (k < K) & (t[k.clamp(max=max(K - 1, 0))] == x) if K else \
        torch.zeros_like(x, dtype=torch.bool)
    hist = torch.bincount(2 * k + eq.to(torch.int64), minlength=2 * K + 1)
    lo = x.min() if x.numel() else torch.tensor(INT32_MAX, device=x.device)
    hi = x.max() if x.numel() else torch.tensor(INT32_MIN, device=x.device)
    return torch.cat([hist[:2 * K + 1], lo.reshape(1), hi.reshape(1)])


# ---------------------------------------------------------------------------
# Host decode (any depth up to 62, int64)
# ---------------------------------------------------------------------------

def decode_values_host(slices_np: np.ndarray, sign_np: np.ndarray,
                       depth: int) -> np.ndarray:
    """(D, W) uint32 magnitude planes and the (W,) sign plane -> (32 W,)
    int64 signed values (bsi.py:289): np.unpackbits, then 8 planes packed
    into one byte of every value at once."""
    if depth > HOST_MAX_DEPTH:
        raise ValueError(f"BSI depth > {HOST_MAX_DEPTH} unsupported (int64 "
                         f"magnitude)")
    d = int(depth)
    bits = np.unpackbits(
        np.ascontiguousarray(slices_np[:d]).view(np.uint8).reshape(d, -1),
        axis=-1, bitorder="little")
    n_bytes = (d + 7) // 8
    if d % 8:
        pad = np.zeros((n_bytes * 8 - d, bits.shape[1]), dtype=np.uint8)
        bits = np.concatenate([bits, pad], axis=0)
    byte_planes = np.packbits(bits.reshape(n_bytes, 8, -1), axis=1,
                              bitorder="little")[:, 0, :]
    vals = byte_planes[0].astype(np.int64)
    for b in range(1, n_bytes):
        vals += byte_planes[b].astype(np.int64) << np.int64(8 * b)
    sign = np.unpackbits(np.ascontiguousarray(sign_np).view(np.uint8),
                         bitorder="little").astype(bool)
    np.negative(vals, out=vals, where=sign)
    return vals


def expand_bits_host(words_np: np.ndarray) -> np.ndarray:
    """(W,) uint32 words -> (32 W,) bool (bsi.py:325)."""
    return np.unpackbits(np.ascontiguousarray(words_np).view(np.uint8),
                         bitorder="little").astype(bool)


# ---------------------------------------------------------------------------
# Sort
# ---------------------------------------------------------------------------

def sort_stacked(vals: torch.Tensor, exists: torch.Tensor, desc: bool,
                 cut: int, filt: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every shard's first `cut` columns in (value, column) order
    (sort_bsi_stacked, bsi.py:661): (S, C) int32 unbased values, (S, W)
    exists [& filter] words -> (idx (S, cut) int64 columns, key (S, cut)
    int64 values, negated when desc, n_present (S,) int64).  The present
    columns come first; entries past n_present are absent columns.

    One int64 key a column, score * C + (C - 1 - column) with score the
    value (negated for ascending) or -2^31 for an absent column, holds the
    order whole: top-k of distinct keys has one answer, whatever order it
    keeps among equals."""
    ex = exists if filt is None else exists & filt
    present = expand_bits(ex).bool()
    S, C = vals.shape
    v = vals.to(torch.int64)
    score = torch.where(present, v if desc else -v, INT32_MIN)
    col = torch.arange(C, dtype=torch.int64, device=vals.device)
    top = torch.topk(score * C + (C - 1 - col), min(cut, C), dim=-1).values
    s = torch.div(top, C, rounding_mode="floor")
    return (C - 1) - (top - s * C), -s, present.sum(-1)


def sort_shard(vals: torch.Tensor, present: torch.Tensor, desc: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's present columns in (value, column) order (_sort_core,
    bsi.py:636): (C,) int32 values and (C,) bool -> (cols int64, vals
    int64), lower column first among equal values."""
    cols = torch.nonzero(present).reshape(-1)
    v = vals[cols].to(torch.int64)
    key = (-v if desc else v) * present.shape[0] + cols
    order = torch.argsort(key)
    return cols[order], v[order]


def after_mask_stacked(vals: torch.Tensor, col0: torch.Tensor,
                       after_val: int, after_col: int, desc: bool
                       ) -> torch.Tensor:
    """Keyset-cursor words (bsi.py:716): the columns strictly after
    (after_val, after_col) in (value, column) order.  (S, C) int32 unbased
    values, (S,) int64 first column of each shard -> (S, W) int32 words.
    Column ids are int64."""
    C = vals.shape[-1]
    gcol = col0.to(torch.int64)[:, None] + torch.arange(
        C, dtype=torch.int64, device=vals.device)[None, :]
    v = vals.to(torch.int64)
    later = (v < after_val) if desc else (v > after_val)
    return pack_bits(later | ((v == after_val) & (gcol > after_col)))


# ---------------------------------------------------------------------------
# Percentile
# ---------------------------------------------------------------------------

# bisection levels a round of kernel I resolves: 2^7 - 1 pivots
PERCENTILE_LEVELS = 7


def nth_ratio(nth) -> Tuple[int, int]:
    """(num, den) with num / den == nth / 100 exactly (nth_limbs,
    bsi.py:431: float(nth).as_integer_ratio())."""
    num, den = float(nth).as_integer_ratio()
    return num, den * 100


def _tdiv2(a: int) -> int:
    """Go's a / 2 (truncates toward zero)."""
    return -((-a) // 2) if a < 0 else a // 2


def pivot(lo: int, hi: int) -> int:
    """The reference's bisection pivot (executor.go:1497-1500)."""
    return _tdiv2(lo) + _tdiv2(hi) + _tdiv2(
        _tdiv2(lo) * -2 + lo + _tdiv2(hi) * -2 + hi)


def pivot_tree(lo: int, hi: int, levels: int) -> List[int]:
    """Every pivot the next `levels` probes from (lo, hi) can visit: each
    probe either ends the walk or continues in (lo, p - 1) or (p + 1, hi)."""
    out, level = [], [(lo, hi)]
    for _ in range(levels):
        nxt = []
        for a, b in level:
            if a < b:
                p = pivot(a, b)
                out.append(p)
                nxt += [(a, p - 1), (p + 1, b)]
        level = nxt
    return out


def percentile(vals: torch.Tensor, exists: torch.Tensor, filt: torch.Tensor,
               base: int, nth,
               counts: Optional[Callable[..., torch.Tensor]] = None
               ) -> Tuple[int, int]:
    """(value, count) of percentile_fused (bsi.py:491) over stacked
    unbased values: (0, 0) when no column is present; the min (max) with
    its count when floor(total * nth / 100) is 0 and the rest is not (when
    the rest is 0); else the bisection's last pivot with count 1.  The
    probes are the reference's one at a time (executor.go:1310), with every
    threshold an exact rational test in Python ints (left > floor(total *
    num / den)), not Go's float64.  Each round of `counts` (kernel I)
    counts every pivot of the next PERCENTILE_LEVELS probes at once; the
    first also counts the min and the max.  Values + base must fit int32
    (the caller's fast-path condition).  `counts` replaces kernel I's
    wrapper (ops/cuda_kernels.py percentile_counts), as a test's oracle."""
    counts = counts or ck.percentile_counts

    def run(thresholds) -> Dict[int, Tuple[int, int]]:
        ts = sorted(set(thresholds))
        h = counts(vals, exists, filt, base, ts).cpu().tolist()
        below, out = 0, {}
        for k, t in enumerate(ts):
            below += h[2 * k]
            out[t] = (below, h[2 * k + 1])     # (count < t, count == t)
            below += h[2 * k + 1]
        return out

    prep = counts(vals, exists, filt, base, []).cpu().tolist()
    total, mn, mx = prep
    if total == 0:
        return 0, 0
    num, den = nth_ratio(nth)
    less, greater = total * num // den, total * (den - num) // den
    interior = less != 0 and greater != 0
    counted = run([mn, mx] + (pivot_tree(mn, mx, PERCENTILE_LEVELS)
                              if interior else []))
    if greater == 0:
        return mx, counted[mx][1]
    if less == 0:
        return mn, counted[mn][1]
    lo, hi, poss = mn, mx, mn
    while lo < hi:
        p = pivot(lo, hi)
        if p not in counted:
            counted.update(run(pivot_tree(lo, hi, PERCENTILE_LEVELS)))
        poss = p
        left, at = counted[p]
        if left > less:
            hi = p - 1
        elif total - left - at > greater:
            lo = p + 1
        else:
            break
    return poss, 1
