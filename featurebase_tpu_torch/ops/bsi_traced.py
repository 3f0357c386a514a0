"""BSI range comparators: plain torch, and their lowering to kernel programs.

Counterpart of featurebase_tpu/ops/bsi_traced.py (reference
fragment.go:963-1305 rangeEQ/LT/GT/Between).  There the predicate bits are
traced so one XLA program serves every literal; here they are host values at
launch time, so every ``_sel(pred_bits[i], x, y)`` resolves on the host: the
torch comparators pick the branch in Python, and the ``expr_*`` functions
turn each comparator into an expression of a few kernel-A instructions
(ops/lowering.py, ops/cuda_kernels.py ``plan_eval``): the sign split in set
algebra, and each unsigned walk as one ``OP_BSI`` whose payload holds the
predicate bits.

Inputs of the torch comparators:
  slices: (..., D, W) int32 magnitude planes (leading dims = stacked shards)
  exists, sign, filter_: (..., W) int32
  pred_bits: (D+1,) {0,1} host ints — |pred| magnitude bits (encode_pred)
  pred_neg: host {0,1} — 1 if pred < 0

The comparators walk depth+1 planes: plane `depth` is a virtual all-zero
slice, so saturated out-of-range predicates resolve correctly (reference:
baseValue clamping, field.go:2412).
"""
from __future__ import annotations

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import (BSI_EXISTS_ROW, BSI_OFFSET,
                                               BSI_SIGN_ROW)
from featurebase_tpu_torch.ops import cuda_kernels as ck


def _slice(slices, i, depth, like):
    return slices[..., i, :] if i < depth else torch.zeros_like(like)


def _split(exists, sign, filter_):
    base = exists & filter_
    return base, base & ~sign, base & sign


def u_eq_t(slices, base, pred_bits, depth: int):
    b = base
    for i in range(depth, -1, -1):
        s = _slice(slices, i, depth, base)
        b = (b & s) if pred_bits[i] else (b & ~s)
    return b


def u_lt_t(slices, base, pred_bits, depth: int, allow_eq: bool):
    b = base
    keep = torch.zeros_like(base)
    for i in range(depth, -1, -1):
        s = _slice(slices, i, depth, base)
        if pred_bits[i]:
            keep = keep | (b & ~s)
            b = b & s
        else:
            b = b & ~s
    return keep | b if allow_eq else keep


def u_gt_t(slices, base, pred_bits, depth: int, allow_eq: bool):
    b = base
    keep = torch.zeros_like(base)
    for i in range(depth, -1, -1):
        s = _slice(slices, i, depth, base)
        if pred_bits[i]:
            b = b & s
        else:
            keep = keep | (b & s)
            b = b & ~s
    return keep | b if allow_eq else keep


def range_eq_t(slices, exists, sign, filter_, pred_bits, pred_neg,
               depth: int):
    _, pos, neg = _split(exists, sign, filter_)
    return u_eq_t(slices, neg if pred_neg else pos, pred_bits, depth)


def range_neq_t(slices, exists, sign, filter_, pred_bits, pred_neg,
                depth: int):
    base = exists & filter_
    eq = range_eq_t(slices, exists, sign, filter_, pred_bits, pred_neg, depth)
    return base & ~eq


def range_lt_t(slices, exists, sign, filter_, pred_bits, pred_neg,
               depth: int, allow_eq: bool):
    """value < pred (<= if allow_eq), sign-magnitude semantics."""
    _, pos, neg = _split(exists, sign, filter_)
    if pred_neg:
        return u_gt_t(slices, neg, pred_bits, depth, allow_eq)
    return neg | u_lt_t(slices, pos, pred_bits, depth, allow_eq)


def range_gt_t(slices, exists, sign, filter_, pred_bits, pred_neg,
               depth: int, allow_eq: bool):
    _, pos, neg = _split(exists, sign, filter_)
    if pred_neg:
        return pos | u_lt_t(slices, neg, pred_bits, depth, allow_eq)
    return u_gt_t(slices, pos, pred_bits, depth, allow_eq)


def range_between_t(slices, exists, sign, filter_, lo_bits, lo_neg,
                    hi_bits, hi_neg, depth: int):
    a = range_gt_t(slices, exists, sign, filter_, lo_bits, lo_neg, depth, True)
    b = range_lt_t(slices, exists, sign, filter_, hi_bits, hi_neg, depth, True)
    return a & b


def encode_pred(pred: int, depth: int):
    """Host helper: int predicate -> (pred_bits (D+1,) uint32, pred_neg).

    The magnitude is saturated to 2^(depth+1)-1 so any out-of-range pred has
    the virtual MSB (plane `depth`) set, which the comparators resolve as
    all-match / no-match (reference: baseValue clamping, field.go:2412)."""
    mag = min(abs(int(pred)), (1 << (depth + 1)) - 1)
    bits = np.array([(mag >> i) & 1 for i in range(depth + 1)],
                    dtype=np.uint32)
    return bits, np.uint32(1 if pred < 0 else 0)


# ---------------------------------------------------------------------------
# Lowering to kernel programs.  Each comparator becomes an expression of
# ops/lowering.py over the planes of one BSI leaf: the sign split in set
# algebra and each unsigned walk as OP_BSI walks.  One OP_BSI walks at most
# ck.MAX_DEPTH (32) magnitude planes; a deeper walk is split into one over
# the high planes, which carries the virtual plane's bit, and one over the
# low 32, which carries a zero:
#   eq = eq_hi & eq_lo        (the low walk applied to eq_hi in place)
#   gt = gt_hi | (eq_hi & gt_lo),  lt the same way
# with allow_eq on the low walk only.  The filter is all-ones in plans
# (executor/plan.py), so base = exists.  executor/plan.py and ops/bsi.py
# lower whole expressions within kernel A's limits with lowering.lower.
# ---------------------------------------------------------------------------

class LeafPlanes:
    """The plane expressions of one (S, D+2, W) BSI leaf: row 0 exists, row
    1 sign, row 2+i magnitude slice i, each keyed (key, row) so that every
    expression over the leaf names one plane of a program alike."""

    __slots__ = ("key", "tensor")

    def __init__(self, key, tensor: torch.Tensor):
        self.key = key
        self.tensor = tensor

    def row(self, j: int):
        return ("plane", (self.key, j), self.tensor[:, j])

    def exists(self):
        return self.row(BSI_EXISTS_ROW)

    def mags(self, lo: int, hi: int) -> tuple:
        return tuple(self.row(BSI_OFFSET + i) for i in range(lo, hi))


_MODES = {"eq": ck.MODE_EQ, "lt": ck.MODE_LT, "gt": ck.MODE_GT}


def _walk(leaf: LeafPlanes, src, pred_bits, depth: int, mode: str,
          allow_eq: bool = False):
    """The unsigned walk from plane `depth` (virtual zero) down to 0 over
    the side `src`: one OP_BSI, or a split pair past ck.MAX_DEPTH planes.
    mode: 'eq', 'lt' or 'gt'."""
    bits = tuple(int(b) for b in pred_bits)
    if depth <= ck.MAX_DEPTH:
        return ("walk", src, leaf.mags(0, depth), _MODES[mode], bits,
                allow_eq)
    lo = ck.MAX_DEPTH
    hi_planes, hi_bits = leaf.mags(lo, depth), bits[lo:depth + 1]
    lo_planes, lo_bits = leaf.mags(0, lo), bits[:lo] + (0,)
    eq_hi = ("walk", src, hi_planes, ck.MODE_EQ, hi_bits, False)
    if mode == "eq":
        return ("walk", eq_hi, lo_planes, ck.MODE_EQ, lo_bits, False)
    return ("or", ("walk", src, hi_planes, _MODES[mode], hi_bits, False),
            ("walk", eq_hi, lo_planes, _MODES[mode], lo_bits, allow_eq))


def _side(leaf: LeafPlanes, want: str):
    """The positive ('pos') or negative ('neg') existing side: exists &
    ~sign, or exists & sign."""
    return ("andnot" if want == "pos" else "and", leaf.exists(),
            leaf.row(BSI_SIGN_ROW))


def expr_eq(leaf: LeafPlanes, pred_bits, pred_neg, depth: int):
    return _walk(leaf, _side(leaf, "neg" if pred_neg else "pos"), pred_bits,
                 depth, "eq")


def expr_neq(leaf: LeafPlanes, pred_bits, pred_neg, depth: int):
    return ("andnot", leaf.exists(), expr_eq(leaf, pred_bits, pred_neg,
                                             depth))


def expr_lt(leaf: LeafPlanes, pred_bits, pred_neg, depth: int,
            allow_eq: bool):
    if pred_neg:
        return _walk(leaf, _side(leaf, "neg"), pred_bits, depth, "gt",
                     allow_eq)
    return ("or", _walk(leaf, _side(leaf, "pos"), pred_bits, depth, "lt",
                        allow_eq), _side(leaf, "neg"))


def expr_gt(leaf: LeafPlanes, pred_bits, pred_neg, depth: int,
            allow_eq: bool):
    if pred_neg:
        return ("or", _walk(leaf, _side(leaf, "neg"), pred_bits, depth, "lt",
                            allow_eq), _side(leaf, "pos"))
    return _walk(leaf, _side(leaf, "pos"), pred_bits, depth, "gt", allow_eq)


def expr_between(leaf: LeafPlanes, lo_bits, lo_neg, hi_bits, hi_neg,
                 depth: int):
    return ("and", expr_gt(leaf, lo_bits, lo_neg, depth, True),
            expr_lt(leaf, hi_bits, hi_neg, depth, True))
