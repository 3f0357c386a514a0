"""BSI aggregates over a stacked group: the plain PyTorch versions of
kernels C and D, and their host finishes.

Counterpart of the aggregates of featurebase_tpu/ops/bsi.py:
``sum_planes_stacked`` (:378), ``min_max_stacked`` (:399) and the per-shard
descents of ``minmax_parts_kernel`` / ``_descend`` behind ``min_host`` and
``max_host`` (:200-278).  A stacked group is an (S, D + 2, W) int32 tensor:
plane 0 exists, plane 1 sign, plane 2 + i magnitude bit i (core/consts.py);
values are stored relative to the field's base, as sign and magnitude.

- ``sum_planes_plain``: (2D + 1,) int64, the set-bit counts of each plane
  under the positive columns, then under the negative columns, then of the
  columns, over every shard, with e = exists & filter (the output of
  kernel C').
- ``min_max_parts_plain``: (S, 4, 2) int64: per shard the greedy descents
  pos-min, pos-max, neg-min, neg-max, each as (magnitude, count of the
  columns at it); a Min runs the first and the last, a Max the middle two;
  a count of 0 means that side of the shard is empty or that the descent
  did not run (the output of kernel D').
- ``min_max_stacked_finish`` and ``min_max_per_shard``: the reference
  executor's two semantics for Min/Max, which it picks by depth
  (executor/executor.py).
- ``sum_groups_plain``: (G, 2D + 1) int64, kernel C's counters for each of
  G masks (kernel F's output; ``sum_groups_stacked`` bsi.py:611 and
  ``sum_groups_kernel`` :333), and ``finish_groups``, each group's exact
  (sum, count).
- ``var_moments_plain`` and ``corr_moments_plain``: the raw counts of
  Var and Corr (``var_moments_stacked`` bsi.py:782 and
  ``corr_moments_stacked`` :815; kernel H's output), and
  ``finalize_var_moments`` and ``finalize_cross_moments``, their exact
  finishes in Python ints.
- ``range_eq`` ... ``range_between`` (bsi.py:114-160): the static-predicate
  comparators of one shard's group, lowered with ops/bsi_traced.py onto
  kernel A at S = 1 in word mode (the per-shard interpreter's BSI rows).

The wrappers ``bsi_sum_planes``, ``bsi_min_max``, ``bsi_sum_groups``,
``var_moments`` and ``corr_moments`` in ops/cuda_kernels.py run these on CPU tensors and the kernels on CUDA
tensors.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from featurebase_tpu_torch.ops import bsi_traced as bst
from featurebase_tpu_torch.ops import lowering
from featurebase_tpu_torch.ops.cuda_kernels import popcount_words
from featurebase_tpu_torch.parallel.agg import finalize_sum

POS_MIN, POS_MAX, NEG_MIN, NEG_MAX = range(4)
# the deepest group: magnitudes of the port's Field are int64
MAX_DEPTH = 63


def _split(group: torch.Tensor, filt: torch.Tensor):
    e = group[:, 0] & filt
    sign = group[:, 1]
    return e, e & ~sign, e & sign


def sum_planes_plain(group: torch.Tensor, filt: torch.Tensor
                     ) -> torch.Tensor:
    """(S, D + 2, W) group, (S, W) filter -> (2D + 1,) int64: positive
    plane counts, negative plane counts, the count (sum_planes_stacked,
    bsi.py:378, in int64)."""
    D = group.shape[1] - 2
    e, pos, neg = _split(group, filt)
    out = torch.empty(2 * D + 1, dtype=torch.int64, device=group.device)
    for d in range(D):
        plane = group[:, 2 + d]
        out[d] = popcount_words(plane & pos).sum()
        out[D + d] = popcount_words(plane & neg).sum()
    out[2 * D] = popcount_words(e).sum()
    return out


def _descend(c: torch.Tensor, group: torch.Tensor, maximize: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy descent of bsi.py:252 over each shard's whole row of
    columns `c` ((S, W)): (magnitude (S,), count of columns at it (S,))."""
    D = group.shape[1] - 2
    mag = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    nonempty = (c != 0).any(1)
    for d in range(D - 1, -1, -1):
        plane = group[:, 2 + d]
        t = c & plane if maximize else c & ~plane
        hit = (t != 0).any(1)
        c = torch.where(hit[:, None], t, c)
        bit = hit if maximize else ~hit & nonempty
        mag |= bit.to(torch.int64) << d
    return mag, popcount_words(c).sum(1)


def min_max_parts_plain(group: torch.Tensor, filt: torch.Tensor,
                        is_min: bool) -> torch.Tensor:
    """(S, D + 2, W) group, (S, W) filter -> (S, 4, 2) int64: per shard
    (magnitude, count) of the descents pos-min, pos-max, neg-min, neg-max.
    A Min (is_min) runs pos-min and neg-max, a Max pos-max and neg-min; the
    other two are (0, 0)."""
    _, pos, neg = _split(group, filt)
    out = torch.zeros((group.shape[0], 4, 2), dtype=torch.int64,
                      device=group.device)
    runs = ((POS_MIN, pos, False), (NEG_MAX, neg, True)) if is_min else \
        ((POS_MAX, pos, True), (NEG_MIN, neg, False))
    for k, c, maximize in runs:
        out[:, k, 0], out[:, k, 1] = _descend(c, group, maximize)
    return out


def min_max_stacked_finish(parts: np.ndarray, is_min: bool
                           ) -> Tuple[int, int]:
    """(extreme value, count of columns equal to it) over every shard, with
    min_max_stacked's semantics (bsi.py:399): the values are the signed
    decodes, so a sign-set column of magnitude 0 is 0 and ties with the
    positive zeros; (0, 0) when no column matched.  Values are unbased.

    Each shard offers its most negative and its smallest positive value for
    Min (its largest positive and least negative for Max), with their
    counts; equal values add their counts."""
    found = {}
    for s in range(parts.shape[0]):
        if is_min:
            offers = ((-int(parts[s, NEG_MAX, 0]), int(parts[s, NEG_MAX, 1])),
                      (int(parts[s, POS_MIN, 0]), int(parts[s, POS_MIN, 1])))
        else:
            offers = ((int(parts[s, POS_MAX, 0]), int(parts[s, POS_MAX, 1])),
                      (-int(parts[s, NEG_MIN, 0]), int(parts[s, NEG_MIN, 1])))
        for v, c in offers:
            if c:
                found[v] = found.get(v, 0) + c
    if not found:
        return 0, 0
    best = min(found) if is_min else max(found)
    return best, found[best]


def min_max_per_shard(parts: np.ndarray, is_min: bool
                      ) -> List[Tuple[int, int]]:
    """Per shard (value, count) with min_host / max_host's semantics
    (bsi.py:228-249): Min takes the shard's negatives first when it has
    any, Max its positives; a sign-set zero is not merged with the shard's
    positive zeros.  (0, 0) for a shard with no column.  Unbased."""
    # a descent never empties its set: the count of either descent of a
    # sign class says whether the shard has a column of it
    kp, kn = (POS_MIN, NEG_MAX) if is_min else (POS_MAX, NEG_MIN)
    out = []
    for s in range(parts.shape[0]):
        has_pos, has_neg = parts[s, kp, 1] > 0, parts[s, kn, 1] > 0
        if is_min:
            k, sign = (NEG_MAX, -1) if has_neg else (POS_MIN, 1)
        else:
            k, sign = (POS_MAX, 1) if has_pos else (NEG_MIN, -1)
        if not (has_pos or has_neg):
            out.append((0, 0))
        else:
            out.append((sign * int(parts[s, k, 0]), int(parts[s, k, 1])))
    return out


# ---------------------------------------------------------------------------
# GroupBy sums (kernel F's plain version and finish)
# ---------------------------------------------------------------------------

def sum_groups_plain(group: torch.Tensor, masks: torch.Tensor
                     ) -> torch.Tensor:
    """(S, D + 2, W) group, (S, G, W) masks -> (G, 2D + 1) int64: for each
    mask, sum_planes_plain's counters with the mask as the filter
    (sum_groups_stacked, bsi.py:611: its three outputs side by side, in
    int64)."""
    D = group.shape[1] - 2
    e = masks & group[:, None, 0]
    sign = group[:, None, 1]
    pos, neg = e & ~sign, e & sign
    out = torch.empty((masks.shape[1], 2 * D + 1), dtype=torch.int64,
                      device=group.device)
    for d in range(D):
        plane = group[:, None, 2 + d]
        out[:, d] = popcount_words(plane & pos).sum((0, 2))
        out[:, D + d] = popcount_words(plane & neg).sum((0, 2))
    out[:, 2 * D] = popcount_words(e).sum((0, 2))
    return out


def finish_groups(parts: np.ndarray) -> List[Tuple[int, int]]:
    """(G, 2D + 1) counters -> each group's (sum, count), exact Python ints
    (sum_groups_host, bsi.py:353).  Sums are unbased."""
    D = (parts.shape[1] - 1) // 2
    return [(finalize_sum(p[:D], p[D:2 * D]), int(p[2 * D])) for p in parts]


# ---------------------------------------------------------------------------
# Statistical moments (kernel H's plain versions and finishes; SQL VAR/CORR)
# ---------------------------------------------------------------------------

# the deepest group kernel H and the moments' device route take (the
# reference runs deeper fields on the host, executor.py:1388, :1452)
MAX_MOMENTS_DEPTH = 31


def _square(planes: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(D, D) int64: entry (i, j) the set bits of plane i & plane j & keep
    over every shard, a shard at a time (its temporaries stay small) and
    the upper triangle mirrored."""
    D = planes.shape[1]
    out = torch.zeros((D, D), dtype=torch.int64, device=planes.device)
    for s in range(planes.shape[0]):
        kept = planes[s] & keep[s]
        for i in range(D):
            out[i, i:] += popcount_words(kept[i:] & planes[s, i]).sum(1)
    low = torch.tril_indices(D, D, -1, device=planes.device)
    out[low[0], low[1]] = out[low[1], low[0]]
    return out


def _counts(x: torch.Tensor) -> torch.Tensor:
    """(D,) int64 set bits of each plane of (S, D, W) words."""
    return popcount_words(x).sum((0, 2))


def var_moments_plain(group: torch.Tensor, filt: torch.Tensor):
    """(S, D + 2, W) group, (S, W) filter -> (cnt (), p (D,), n (D,),
    sq (D, D)), int64, as var_moments_stacked (bsi.py:782) lays them out:
    with e = exists & filter, cnt its set bits, p[i] and n[i] plane i's
    under e & ~sign and e & sign, sq[i][j] those of plane i & plane j & e."""
    e, pos, neg = _split(group, filt)
    planes = group[:, 2:]
    return (popcount_words(e).sum(), _counts(planes & pos[:, None]),
            _counts(planes & neg[:, None]), _square(planes, e))


def corr_moments_plain(gx: torch.Tensor, gy: torch.Tensor,
                       filt: torch.Tensor):
    """Two (S, D + 2, W) groups, (S, W) filter -> (cnt, xp, xn, yp, yn,
    sqx, sqy, pp, pm, mp, mm), int64, as corr_moments_stacked (bsi.py:815)
    lays them out, over present = exists_x & exists_y & filter: each
    field's var_moments_plain terms, and the (Dx, Dy) matrices of plane
    x_i & plane y_j under each sign class (x positive or not, y positive or
    not), a shard at a time."""
    present, xp, xn = _split(gx, gy[:, 0] & filt)
    _, yp, yn = _split(gy, present)
    X, Y = gx[:, 2:], gy[:, 2:]
    xs = (X & xp[:, None], X & xn[:, None])
    ys = (Y & yp[:, None], Y & yn[:, None])
    cross = torch.zeros((4, X.shape[1], Y.shape[1]), dtype=torch.int64,
                        device=X.device)
    for s in range(X.shape[0]):
        for i in range(X.shape[1]):
            for k, (a, b) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                cross[k, i] += popcount_words(xs[a][s, i] & ys[b][s]).sum(1)
    return (popcount_words(present).sum(), _counts(xs[0]), _counts(xs[1]),
            _counts(ys[0]), _counts(ys[1]), _square(X, present),
            _square(Y, present), *cross)


def finalize_var_moments(cnt, p, n, sq, base: int):
    """Exact (n, sum, sum of squares) of the true values from raw counts
    (Python big ints; x = stored + base, stored sign-magnitude)
    (bsi.py:868)."""
    cnt = int(cnt)
    s_stored = sum((1 << i) * (int(p[i]) - int(n[i])) for i in range(len(p)))
    sq_stored = sum((1 << (i + j)) * int(sq[i][j])
                    for i in range(len(p)) for j in range(len(p)))
    total = s_stored + base * cnt
    total_sq = sq_stored + 2 * base * s_stored + base * base * cnt
    return cnt, total, total_sq


def finalize_cross_moments(xp, xn, yp, yn, classes, base_x: int,
                           base_y: int, cnt: int):
    """Exact (sum x, sum y, sum xy) of the true values from raw counts
    (bsi.py:880)."""
    sx = sum((1 << i) * (int(xp[i]) - int(xn[i])) for i in range(len(xp)))
    sy = sum((1 << j) * (int(yp[j]) - int(yn[j])) for j in range(len(yp)))
    pp, pm, mp, mm = classes
    sxy = sum((1 << (i + j)) * (int(pp[i][j]) - int(pm[i][j])
                                - int(mp[i][j]) + int(mm[i][j]))
              for i in range(len(xp)) for j in range(len(yp)))
    tx = sx + base_x * cnt
    ty = sy + base_y * cnt
    txy = sxy + base_x * sy + base_y * sx + base_x * base_y * cnt
    return tx, ty, txy


# ---------------------------------------------------------------------------
# Static-predicate comparators of one shard (bsi.py:114-160)
# ---------------------------------------------------------------------------

def _range(group: torch.Tensor, build, *args) -> torch.Tensor:
    """Run one comparator expression (ops/bsi_traced.py ``expr_*``) over a
    shard's (D + 2, W) group with kernel A in word mode -> (W,) int32 words
    (a group deeper than kernel A's planes spills, ops/lowering.py)."""
    g = group[None]
    expr = build(bst.LeafPlanes("bsi", g), *args)
    return lowering.run_words(expr, 1, g.shape[2])[0]


def _pred(pred: int, depth: int):
    bits, neg = bst.encode_pred(pred, depth)
    return bits, int(neg)


def range_eq(group: torch.Tensor, pred: int, depth: int) -> torch.Tensor:
    return _range(group, bst.expr_eq, *_pred(pred, depth), depth)


def range_neq(group: torch.Tensor, pred: int, depth: int) -> torch.Tensor:
    return _range(group, bst.expr_neq, *_pred(pred, depth), depth)


def range_lt(group: torch.Tensor, pred: int, depth: int,
             allow_eq: bool = False) -> torch.Tensor:
    return _range(group, bst.expr_lt, *_pred(pred, depth), depth, allow_eq)


def range_gt(group: torch.Tensor, pred: int, depth: int,
             allow_eq: bool = False) -> torch.Tensor:
    return _range(group, bst.expr_gt, *_pred(pred, depth), depth, allow_eq)


def range_between(group: torch.Tensor, lo: int, hi: int, depth: int
                  ) -> torch.Tensor:
    """lo <= value <= hi."""
    return _range(group, bst.expr_between, *_pred(lo, depth),
                  *_pred(hi, depth), depth)
