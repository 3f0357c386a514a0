"""BSI range comparators: plain torch, and their lowering to kernel programs.

Counterpart of featurebase_tpu/ops/bsi_traced.py (reference
fragment.go:963-1305 rangeEQ/LT/GT/Between).  There the predicate bits are
traced so one XLA program serves every literal; here they are host values at
launch time, so every ``_sel(pred_bits[i], x, y)`` resolves on the host: the
torch comparators pick the branch in Python, and the ``lower_*`` functions
turn each comparator into a few kernel-A instructions (ops/cuda_kernels.py
``plan_eval``): the sign split in set algebra, and each unsigned walk as one
``OP_BSI`` whose payload holds the predicate bits.

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
# Lowering to kernel programs.  Every function takes a BsiPlanes view of one
# BSI leaf and returns a register holding its result (the caller frees it).
# The filter is all-ones in plans (executor/plan.py), so base = exists.
# ---------------------------------------------------------------------------

class BsiPlanes:
    """Plane ids of one (S, D+2, W) BSI leaf in a ProgramBuilder, registered
    on first use: row 0 exists, row 1 sign, row 2+i magnitude slice i."""

    __slots__ = ("pb", "key", "tensor")

    def __init__(self, pb: ck.ProgramBuilder, key, tensor: torch.Tensor):
        self.pb = pb
        self.key = key
        self.tensor = tensor

    def row(self, j: int) -> int:
        return self.pb.plane((self.key, j), self.tensor[:, j])

    def exists(self) -> int:
        return self.row(BSI_EXISTS_ROW)

    def sign(self) -> int:
        return self.row(BSI_SIGN_ROW)

    def slice(self, i: int) -> int:
        return self.row(BSI_OFFSET + i)

    def slices(self, depth: int) -> int:
        """Id of magnitude slice 0; slices 0 .. depth - 1 get consecutive
        ids, as one OP_BSI walk names them."""
        ids = [self.slice(i) for i in range(depth)]
        if ids != list(range(ids[0], ids[0] + depth)):
            raise ValueError(f"slices of {self.key!r} are not consecutive "
                             f"planes: {ids}")
        return ids[0]


_MODES = {"eq": ck.MODE_EQ, "lt": ck.MODE_LT, "gt": ck.MODE_GT}


def _lower_u(pb: ck.ProgramBuilder, planes: BsiPlanes, b: int, pred_bits,
             depth: int, mode: str, allow_eq: bool = False) -> int:
    """Unsigned walk from plane `depth` (virtual zero) down to 0 over the
    side in register `b`, in place: one OP_BSI.  mode: 'eq', 'lt' or
    'gt'."""
    return pb.bsi(b, planes.slices(depth), depth, _MODES[mode], pred_bits,
                  allow_eq)


def _lower_sides(pb: ck.ProgramBuilder, planes: BsiPlanes, want: str) -> int:
    """Register with the positive ('pos') or negative ('neg') existing side:
    exists & ~sign, or exists & sign."""
    ex = pb.load(planes.exists())
    sg = pb.load(planes.sign())
    pb.op(ck.OP_ANDNOT if want == "pos" else ck.OP_AND, ex, sg, dst=ex)
    pb.free(sg)
    return ex


def lower_eq(pb, planes: BsiPlanes, pred_bits, pred_neg, depth: int) -> int:
    side = _lower_sides(pb, planes, "neg" if pred_neg else "pos")
    return _lower_u(pb, planes, side, pred_bits, depth, "eq")


def lower_neq(pb, planes: BsiPlanes, pred_bits, pred_neg, depth: int) -> int:
    eq = lower_eq(pb, planes, pred_bits, pred_neg, depth)
    ex = pb.load(planes.exists())
    pb.op(ck.OP_ANDNOT, ex, eq, dst=ex)
    pb.free(eq)
    return ex


def lower_lt(pb, planes: BsiPlanes, pred_bits, pred_neg, depth: int,
             allow_eq: bool) -> int:
    if pred_neg:
        neg = _lower_sides(pb, planes, "neg")
        return _lower_u(pb, planes, neg, pred_bits, depth, "gt", allow_eq)
    pos = _lower_sides(pb, planes, "pos")
    r = _lower_u(pb, planes, pos, pred_bits, depth, "lt", allow_eq)
    neg = _lower_sides(pb, planes, "neg")
    pb.op(ck.OP_OR, r, neg, dst=r)
    pb.free(neg)
    return r


def lower_gt(pb, planes: BsiPlanes, pred_bits, pred_neg, depth: int,
             allow_eq: bool) -> int:
    if pred_neg:
        neg = _lower_sides(pb, planes, "neg")
        r = _lower_u(pb, planes, neg, pred_bits, depth, "lt", allow_eq)
        pos = _lower_sides(pb, planes, "pos")
        pb.op(ck.OP_OR, r, pos, dst=r)
        pb.free(pos)
        return r
    pos = _lower_sides(pb, planes, "pos")
    return _lower_u(pb, planes, pos, pred_bits, depth, "gt", allow_eq)


def lower_between(pb, planes: BsiPlanes, lo_bits, lo_neg, hi_bits, hi_neg,
                  depth: int) -> int:
    a = lower_gt(pb, planes, lo_bits, lo_neg, depth, True)
    b = lower_lt(pb, planes, hi_bits, hi_neg, depth, True)
    pb.op(ck.OP_AND, a, b, dst=a)
    pb.free(b)
    return a
