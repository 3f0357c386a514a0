"""Plan compiler and plan executor for bitmap expressions (PyTorch/CUDA).

Counterpart of featurebase_tpu/executor/plan.py.  ``PlanCompiler`` (own
copy, reference executor.go:679-846 executeCall) compiles a PQL bitmap call
tree into an IR over stacked shard tiles:

    leaves:  each distinct data source (a field row, a BSI group, the
             existence row, an embedded const row) becomes one input tensor
             of shape (S, W) or (S, D+2, W) — all shards batched on axis 0.
    params:  BSI predicate literals, as host bit vectors (encode_pred).

``PlanExecutor`` gathers the leaves from the fragments' host masters into
generation-keyed device caches (uploads through pinned host buffers; each
entry registered with the residency LRU of storage/residency.py, and
served without a walk of the fragments while its field's write clock has
not moved, model/clock.py), lowers the IR to a register program over leaf
planes (``lower_ir``: each BSI comparator becomes a sign split and OP_BSI
walks with its predicate bits in the payload, split in two past 32 planes;
a Shift subtree is evaluated first and enters as a leaf; children are
emitted in Sethi-Ullman order, and a subtree that does not fit kernel A's
limits is evaluated first and enters as a leaf too, ops/lowering.py) and
runs it with kernel A
(ops/cuda_kernels.py ``plan_eval``): result words for bitmap calls, fused
per-shard counts for Count.  ``stacked_vals`` caches a field's decoded
values (kernel G'', ``bsi_decode``) the same way, for Distinct, Percentile
and Sort.  Each entry remembers the fragments it was gathered from: a
deleted field, view or index drops the entries built from its fragments in
every live plan executor (``drop_fragment_copies``).

On a mesh (parallel/mesh.py; JAX plan.py:399-471) every stacked entry is a
``Sharded`` array: the shard list is laid out over the members (padded to
a whole block per member, or in the owner-placed order of
parallel/placement.py when a policy is active), each local member's block
is built from the host masters of its own shards only and uploaded to its
device, and each block registers its bytes with the residency LRU (one
budget over every registered byte, as in the JAX package).  A plan runs as
one kernel-A launch per member on that member's block; a Count merges the
members' counts (parallel/agg.py).
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import (BSI_EXISTS_ROW, BSI_OFFSET,
                                               BSI_SIGN_ROW, WORDS_PER_ROW)
from featurebase_tpu_torch.model.field import TYPE_TIME, Field
from featurebase_tpu_torch.model.index import Index
from featurebase_tpu_torch.model.row import Row, host_words
from featurebase_tpu_torch.model.view import VIEW_STANDARD, view_bsi_group
from featurebase_tpu_torch.ops import bitwise as bw
from featurebase_tpu_torch.ops import bsi_traced as bst
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import lowering
from featurebase_tpu_torch.parallel.mesh import Sharded
from featurebase_tpu_torch.pql.ast import Call, Condition
from featurebase_tpu_torch.utils.tracing import TRACER


class PlanError(Exception):
    pass


class _Leaf:
    """A data source to gather: kind in {row, bsi, existence, const, full}."""

    __slots__ = ("kind", "field", "views", "row", "depth", "const_row")

    def __init__(self, kind: str, field: Optional[str] = None,
                 views: Tuple[str, ...] = (), row: int = 0, depth: int = 0,
                 const_row: Optional[Row] = None):
        self.kind = kind
        self.field = field
        self.views = views
        self.row = row
        self.depth = depth
        self.const_row = const_row

    def cache_key(self):
        return (self.kind, self.field, self.views, self.row, self.depth)


# IR node: (op, *operands) where operands are node tuples / leaf ids / statics
class BitmapPlan:
    """Compiled plan: IR tree + leaves + dynamic params."""

    def __init__(self, ir, leaves: List[_Leaf], params: List[np.ndarray],
                 key: tuple):
        self.ir = ir
        self.leaves = leaves
        self.params = params
        self.key = key  # structural key for the jit cache


class PlanCompiler:
    """Compiles a PQL bitmap call tree against an index's schema."""

    def __init__(self, index: Index):
        self.index = index
        self.leaves: List[_Leaf] = []
        self.params: List[np.ndarray] = []
        self._leaf_ids: Dict[tuple, int] = {}

    def _add_leaf(self, leaf: _Leaf) -> int:
        k = leaf.cache_key()
        if leaf.kind != "const" and k in self._leaf_ids:
            return self._leaf_ids[k]
        idx = len(self.leaves)
        self.leaves.append(leaf)
        if leaf.kind != "const":
            self._leaf_ids[k] = idx
        return idx

    def _add_param(self, arr: np.ndarray) -> int:
        self.params.append(arr)
        return len(self.params) - 1

    def compile(self, call: Call) -> BitmapPlan:
        ir = self._node(call)
        return BitmapPlan(ir, self.leaves, self.params, _ir_key(ir))

    # -- tree walk ----------------------------------------------------------

    def _node(self, call: Call):
        name = call.name
        if name in ("Row", "Range"):
            return self._row_node(call)
        if name == "Union":
            if not call.children:  # Union() is the empty row
                return ("leaf", self._add_leaf(
                    _Leaf("const", const_row=Row())))
            return ("or",) + tuple(self._node(c) for c in call.children)
        if name == "Intersect":
            if not call.children:
                raise PlanError("Intersect requires children")
            return ("and",) + tuple(self._node(c) for c in call.children)
        if name == "Difference":
            return ("andnot",) + tuple(self._node(c) for c in call.children)
        if name == "Xor":
            if not call.children:
                return ("leaf", self._add_leaf(
                    _Leaf("const", const_row=Row())))
            return ("xor",) + tuple(self._node(c) for c in call.children)
        if name == "Not":
            ex = ("leaf", self._add_leaf(_Leaf("existence")))
            return ("andnot", ex, self._node(call.children[0]))
        if name == "All":
            return ("leaf", self._add_leaf(_Leaf("existence")))
        if name == "Shift":
            n = int(call.args.get("n", 1))
            return ("shift", n, self._node(call.children[0]))
        if name == "ConstRow":
            cols = [c for c in call.args.get("columns", [])
                    if isinstance(c, int)]
            return ("leaf", self._add_leaf(
                _Leaf("const", const_row=Row.from_columns(cols))))
        if name == "Precomputed":
            return ("leaf", self._add_leaf(
                _Leaf("const", const_row=call.args["_row"])))
        raise PlanError(f"not plannable: {name}")

    def _row_node(self, call: Call):
        fld, val = call.field_arg()
        if fld is None:
            raise PlanError("Row() requires a field argument")
        f = self.index.field(fld)
        if f is None:
            raise PlanError(f"field not found: {fld}")
        if isinstance(val, Condition) or f.is_bsi():
            cond = val if isinstance(val, Condition) else Condition("==", val)
            return self._bsi_node(f, cond)
        if val is None:
            raise PlanError("Row(f=null) not plannable")  # falls back
        row_id = int(val)
        from_t, to_t = call.args.get("from"), call.args.get("to")
        views: Tuple[str, ...] = (VIEW_STANDARD,)
        if f.options.type == TYPE_TIME and (from_t or to_t):
            from datetime import datetime

            from featurebase_tpu_torch.model.timequantum import parse_time
            lo = parse_time(from_t) if from_t else datetime(1, 1, 1)
            hi = parse_time(to_t) if to_t else datetime(9999, 1, 1)
            views = tuple(f.views_for_range(lo, hi))
        return ("leaf", self._add_leaf(_Leaf("row", field=fld, views=views,
                                             row=row_id)))

    def _bsi_node(self, f: Field, cond: Condition):
        depth = max(f.bit_depth, 1)
        leaf = ("leaf", self._add_leaf(_Leaf("bsi", field=f.name,
                                             depth=depth)))
        op, v = cond.op, cond.value

        def enc(x):
            return f.encode_value(x) - f.base

        if op == "!=" and v is None:
            return ("bsi_notnull", leaf)
        if op == "==" and v is None:
            ex = ("leaf", self._add_leaf(_Leaf("existence")))
            return ("bsi_null", ex, leaf)
        if op == "betw":
            lo, hi = v
            lo_i = enc(lo) + (1 if cond.lo_strict else 0)
            hi_i = enc(hi) - (1 if cond.hi_strict else 0)
            lo_b, lo_n = bst.encode_pred(lo_i, depth)
            hi_b, hi_n = bst.encode_pred(hi_i, depth)
            p = self._add_param(lo_b)
            self._add_param(np.asarray(lo_n))
            self._add_param(hi_b)
            self._add_param(np.asarray(hi_n))
            return ("bsi_betw", depth, p, leaf)
        pred = enc(v)
        bits, negf = bst.encode_pred(pred, depth)
        p = self._add_param(bits)
        self._add_param(np.asarray(negf))
        opmap = {"==": "bsi_eq", "!=": "bsi_neq", "<": "bsi_lt",
                 "<=": "bsi_lte", ">": "bsi_gt", ">=": "bsi_gte"}
        if op not in opmap:
            raise PlanError(f"unsupported condition: {op}")
        return (opmap[op], depth, p, leaf)


def _ir_key(ir) -> tuple:
    """Structural key: drops nothing (params are referenced by index; leaf
    ids and depths are structural)."""
    return ir if not isinstance(ir, tuple) else tuple(
        _ir_key(x) if isinstance(x, tuple) else x for x in ir)


# ---------------------------------------------------------------------------
# Lowering of compiled IR to a kernel-A program
# ---------------------------------------------------------------------------

def ir_expr(ir, leaves: List[torch.Tensor], params: List[np.ndarray],
            eval_expr: Callable[[tuple], torch.Tensor]):
    """The IR tree over stacked leaves ((S, W) or (S, D+2, W) int32) as an
    expression of ops/lowering.py.  `eval_expr(expr)` evaluates a Shift
    operand to (S, W) words; the shifted words enter as a plane."""
    bsi: Dict[int, bst.LeafPlanes] = {}

    def bsi_leaf(leaf_node) -> bst.LeafPlanes:
        lid = leaf_node[1]
        if lid not in bsi:
            bsi[lid] = bst.LeafPlanes(("leaf", lid), leaves[lid])
        return bsi[lid]

    def rec(node):
        op = node[0]
        if op == "leaf":
            return ("plane", ("leaf", node[1]), leaves[node[1]])
        if op in ("or", "and", "xor", "andnot"):
            kids = tuple(rec(c) for c in node[1:])
            return kids[0] if len(kids) == 1 else (op, *kids)
        if op == "shift":
            shifted = bw.b_shift(eval_expr(rec(node[2])), node[1])
            return ("plane", ("shift", id(node)), shifted)
        if op == "bsi_notnull":
            return bsi_leaf(node[1]).exists()
        if op == "bsi_null":
            return ("andnot", rec(node[1]), bsi_leaf(node[2]).exists())
        depth, p = node[1], node[2]
        leaf = bsi_leaf(node[3])
        if op == "bsi_betw":
            return bst.expr_between(leaf, params[p], params[p + 1],
                                    params[p + 2], params[p + 3], depth)
        bits, neg = params[p], int(params[p + 1])
        if op == "bsi_eq":
            return bst.expr_eq(leaf, bits, neg, depth)
        if op == "bsi_neq":
            return bst.expr_neq(leaf, bits, neg, depth)
        if op in ("bsi_lt", "bsi_lte"):
            return bst.expr_lt(leaf, bits, neg, depth, op == "bsi_lte")
        if op in ("bsi_gt", "bsi_gte"):
            return bst.expr_gt(leaf, bits, neg, depth, op == "bsi_gte")
        raise PlanError(f"bad IR op: {op}")

    return rec(ir)


def lower_ir(ir, leaves: List[torch.Tensor], params: List[np.ndarray],
             S: int, eval_words: Callable[[ck.Program], torch.Tensor]
             ) -> ck.Program:
    """Lower an IR tree to a register program within kernel A's limits
    (ops/lowering.py: Sethi-Ullman order, and spills of subtrees that do
    not fit).  `eval_words(program)` runs a program to its (S, W) words,
    for Shift operands and spills."""
    def eval_expr(e) -> torch.Tensor:
        return eval_words(lowering.lower(e, S, WORDS_PER_ROW, eval_words))
    return lowering.lower(ir_expr(ir, leaves, params, eval_expr), S,
                          WORDS_PER_ROW, eval_words)


# ---------------------------------------------------------------------------
# Plan execution
# ---------------------------------------------------------------------------

def to_host(t: torch.Tensor) -> np.ndarray:
    """A result's host copy: where the query waits for the card (the span
    device.wait)."""
    with TRACER.span("device.wait"):
        return t.cpu().numpy()


def _generations(frags) -> tuple:
    return tuple(fr.generation if fr is not None else -1 for fr in frags)


# Every live plan executor: a deleted field, view or index drops the
# stacked entries built from its fragments in each (drop_fragment_copies).
_EXECUTORS: "weakref.WeakSet[PlanExecutor]" = weakref.WeakSet()


def drop_fragment_copies(frag_ids) -> None:
    """Drop every plan executor's cached entries built from any of the
    fragments with these ids, with their residency bytes."""
    for pe in list(_EXECUTORS):
        pe.drop_built_from(frag_ids)


class PlanExecutor:
    """Gathers stacked leaves into generation-keyed device caches and runs
    lowered plans with kernel A, over one device or over a mesh (then every
    stacked entry and every result is Sharded)."""

    def __init__(self, holder, device: torch.device, mesh=None):
        self.holder = holder
        self.device = device
        self.mesh = mesh
        self._leaf_cache: Dict[tuple, list] = {}
        # the ids of the fragments each cached entry was gathered from
        self._leaf_frags: Dict[tuple, frozenset] = {}
        _EXECUTORS.add(self)

    def _rkeys(self, key) -> List[tuple]:
        """Residency keys of an entry: one, or one per local member block."""
        if self.mesh is None:
            return [("leaf", id(self), key)]
        return [("leaf", id(self), key, m) for m in self.mesh.local]

    def _publish(self, key, gen, arr, frags, clock: int):
        """Cache an entry (_cached) and register its bytes (each member
        block's on a mesh) with the residency LRU; evicting any block drops
        the entry and the other blocks' registrations."""
        from featurebase_tpu_torch.storage.residency import residency
        entry = [gen, arr, clock]
        self._leaf_cache[key] = entry
        self._leaf_frags[key] = frozenset(id(fr) for fr in frags
                                          if fr is not None)
        rkeys = self._rkeys(key)

        def evict():
            if self._leaf_cache.get(key) is entry:
                self._leaf_cache.pop(key, None)
                self._leaf_frags.pop(key, None)
            for rk in rkeys:
                residency().remove(rk)
        blocks = arr.blocks if isinstance(arr, Sharded) else [arr]
        for rk, b in zip(rkeys, blocks):
            if self._leaf_cache.get(key) is not entry:
                break    # an earlier block of it was evicted meanwhile
            residency().add(rk, b.numel() * 4, evict)

    def _touch(self, key) -> None:
        from featurebase_tpu_torch.storage.residency import residency
        for rk in self._rkeys(key):
            residency().touch(rk)

    def built_from(self, frag_ids) -> List[tuple]:
        """Residency keys of the cached entries gathered from any of these
        fragments."""
        return [rk for k, ids in list(self._leaf_frags.items())
                if not ids.isdisjoint(frag_ids) for rk in self._rkeys(k)]

    def drop_built_from(self, frag_ids) -> None:
        from featurebase_tpu_torch.storage.residency import residency
        for rkey in self.built_from(frag_ids):
            residency().remove(rkey)
            self._leaf_cache.pop(rkey[2], None)
            self._leaf_frags.pop(rkey[2], None)

    def layout(self, index_name: str, shards: List[int]) -> List[int]:
        """The shard list in mesh row order: each process's owned shards at
        its member blocks, padded with -1, when a placement policy is
        active (parallel/placement.py layout; JAX executor.py:845-857),
        else the list padded with -1 to a whole block per member
        (S_pad = S + (-S) % n, JAX plan.py:464-471).  The list itself
        without a mesh.  A list laid out already comes back unchanged."""
        if self.mesh is None:
            return list(shards)
        real = [int(s) for s in shards if s >= 0]
        from featurebase_tpu_torch.parallel import placement
        if placement.active():
            return placement.layout(index_name, real, self.mesh.size)
        return self.mesh.layout(real)

    # -- leaf gathering -----------------------------------------------------

    @staticmethod
    def _pin_diverged(frags) -> bool:
        """True when an active snapshot pin no longer matches these
        fragments' live generations: the generation-keyed caches then belong
        to live readers, so the gather goes uncached through the pin-aware
        Fragment.host_row (model/snapshot.py)."""
        from featurebase_tpu_torch.model.snapshot import current_pin
        pin = current_pin()
        if pin is None:
            return False
        return any(fr is not None and not fr.pin_current(pin)
                   for fr in frags)

    @staticmethod
    def _pin_unmoved(index: Index) -> bool:
        """True when no pin is active or the active pin's capture read
        `index`'s write clock as it reads now: every fragment of the index
        is then as pinned, and _pin_diverged is False for any of them."""
        from featurebase_tpu_torch.model.snapshot import current_pin
        pin = current_pin()
        return pin is None or pin.clock == index.clock.value

    @staticmethod
    def _frag(f, view_name, shard):
        if f is None:
            return None
        v = f.view(view_name)
        return v.fragment(shard) if v else None

    def _gather_leaf(self, index: Index, leaf: _Leaf, shards: List[int]
                     ) -> torch.Tensor:
        """A stacked leaf over `shards` (laid out): the cache's answer, or
        an upload (the span storage.leaf)."""
        with TRACER.span("storage.leaf"):
            return self._gather(index, leaf, shards)

    def _gather(self, index: Index, leaf: _Leaf, shards: List[int]
                ) -> torch.Tensor:
        S = len(shards)
        if leaf.kind == "const":
            rows = [leaf.const_row.segments.get(s) for s in shards]

            def fill_const(si, out):
                if rows[si] is not None:
                    out[:] = host_words(rows[si])
            return self._put_lazy((S, WORDS_PER_ROW), fill_const, shards)
        if leaf.kind == "full":
            def fill_full(si, out):
                out[:] = ~np.uint32(0)
            # constant content: cached with an empty generation, so an
            # unfiltered aggregate uploads its all-ones filter once
            return self._cached_stack(("full", tuple(shards)), index,
                                      index, lambda: ((), (), fill_full),
                                      (S, WORDS_PER_ROW), shards)
        if leaf.kind == "existence":
            ef = index.existence_field()
            if ef is None:
                raise PlanError("no existence field")

            def walk_ex():
                frags = [self._frag(ef, VIEW_STANDARD, s) for s in shards]

                def fill_ex(si, out):
                    if frags[si] is not None:
                        out[:] = frags[si].host_row(0)
                return frags, _generations(frags), fill_ex
            return self._cached_stack(("ex", index.name, tuple(shards)),
                                      index, ef, walk_ex,
                                      (S, WORDS_PER_ROW), shards)
        if leaf.kind == "row":
            f = index.field(leaf.field)

            def walk_row():
                frag_sets = [[self._frag(f, vn, s) for vn in leaf.views]
                             for s in shards]
                flat = [fr for frs in frag_sets for fr in frs]

                def fill_row(si, out):
                    for fr in frag_sets[si]:
                        if fr is not None:
                            np.bitwise_or(out, fr.host_row(leaf.row),
                                          out=out)
                return flat, _generations(flat), fill_row
            ck_ = ("row", index.name, leaf.field, leaf.views, leaf.row,
                   tuple(shards))
            return self._cached_stack(ck_, index, f or index, walk_row,
                                      (S, WORDS_PER_ROW), shards)
        if leaf.kind == "bsi":
            f = index.field(leaf.field)
            D = leaf.depth

            def walk_bsi():
                frags = [self._frag(f, view_bsi_group(leaf.field), s)
                         for s in shards]

                def fill_bsi(si, out):
                    fr = frags[si]
                    if fr is None:
                        return
                    out[0] = fr.host_row(BSI_EXISTS_ROW)
                    out[1] = fr.host_row(BSI_SIGN_ROW)
                    for d in range(D):
                        out[2 + d] = fr.host_row(BSI_OFFSET + d)
                return frags, _generations(frags), fill_bsi
            return self._cached_stack(
                ("bsi", index.name, leaf.field, D, tuple(shards)), index,
                f or index, walk_bsi, (S, D + 2, WORDS_PER_ROW), shards)
        raise PlanError(f"bad leaf kind {leaf.kind}")

    def _put_lazy(self, shape, fill_shard, shards: List[int]):
        """Build a stacked (S, ...) tensor shard by shard in a host buffer
        (pinned when the device is a GPU) and upload it; on a mesh, only
        this process's member blocks of the laid-out list `shards`, each to
        its member's device (Mesh.put_lazy; JAX plan.py:416).  The span
        storage.upload."""
        with TRACER.span("storage.upload"):
            if self.mesh is not None:
                return self.mesh.put_lazy(shape, fill_shard, shards)
            buf = torch.zeros(shape, dtype=torch.int32,
                              pin_memory=self.device.type == "cuda")
            host = buf.numpy().view(np.uint32)
            for si in range(shape[0]):
                fill_shard(si, host[si])
            return buf.to(self.device, non_blocking=True)

    def _cached(self, key, index: Index, owner, walk, build):
        """The cached entry of `key`, whose content is gathered from
        fragments under `owner` (a field, or the index): a generation-keyed
        cache whose entries the residency LRU manages (evicted under memory
        pressure, rebuilt from the host masters on next use).

        An entry is ``[generations, array, clock]``, the clock being
        `owner`'s write clock (model/clock.py) as read before the walk that
        last matched the entry's generations.  While the clock still reads
        so and no pin has moved (_pin_unmoved), none of those fragments
        changed and the entry is served with no walk.  Otherwise the walk
        (counted as storage.leaf_walk): walk() gives the fragments, their
        generation tuple and the fill of build(fill); a pinned read whose
        pin has diverged from them is built uncached and registers nothing,
        matching generations are a hit that takes the new clock reading,
        and anything else is built and published."""
        clock = owner.clock.value
        hit = self._leaf_cache.get(key)
        if hit is not None and hit[2] == clock and self._pin_unmoved(index):
            self._touch(key)
            return hit[1]
        TRACER.count("storage.leaf_walk")
        frags, gen, fill = walk()
        if self._pin_diverged(frags):
            return build(fill)
        hit = self._leaf_cache.get(key)
        if hit is not None and hit[0] == gen:
            hit[2] = clock
            self._touch(key)
            return hit[1]
        arr = build(fill)
        self._publish(key, gen, arr, frags, clock)
        return arr

    def _cached_stack(self, key, index: Index, owner, walk, shape,
                      shards: List[int]):
        """_cached, built by _put_lazy of `shape` over `shards`."""
        return self._cached(key, index, owner, walk,
                            lambda fill: self._put_lazy(shape, fill, shards))

    def stacked_field_rows(self, index: Index, fname: str,
                           views: Tuple[str, ...], row_ids: Tuple[int, ...],
                           shards: List[int]) -> torch.Tensor:
        """(S, R, W) stacked tile of the given row ids across shards (views
        OR-ed, absent rows zero).  Backs TopN (reference: each shard's
        fragment.rows read, executor.go:4077).  Sharded on a mesh.  The
        span storage.leaf."""
        with TRACER.span("storage.leaf"):
            return self._field_rows(index, fname, views, row_ids,
                                    self.layout(index.name, shards))

    def _field_rows(self, index: Index, fname: str, views: Tuple[str, ...],
                    row_ids: Tuple[int, ...], shards: List[int]):
        f = index.field(fname)

        def walk():
            frag_sets = [[self._frag(f, vn, s) for vn in views]
                         for s in shards]
            flat = [fr for frs in frag_sets for fr in frs]

            def fill_rowset(si, out):
                for fr in frag_sets[si]:
                    if fr is None:
                        continue
                    for ri, r in enumerate(row_ids):
                        if fr.has_row(r):
                            np.bitwise_or(out[ri], fr.host_row(r),
                                          out=out[ri])
            return flat, _generations(flat), fill_rowset
        return self._cached_stack(
            ("rowset", index.name, fname, views, row_ids, tuple(shards)),
            index, f or index, walk,
            (len(shards), len(row_ids), WORDS_PER_ROW), shards)

    def stacked_bsi(self, index: Index, fname: str, depth: int,
                    shards: List[int]) -> torch.Tensor:
        """(S, depth + 2, W) stacked BSI group: the same cached leaf that
        Count's range predicates read (Sharded on a mesh).  The span
        storage.leaf."""
        with TRACER.span("storage.leaf"):
            return self._gather(index, _Leaf("bsi", field=fname,
                                             depth=depth),
                                self.layout(index.name, shards))

    def stacked_vals(self, index: Index, fname: str, depth: int,
                     shards: List[int]) -> torch.Tensor:
        """(S, 2^20) int32 decoded values of a field (depth <= 31), unbased
        and undefined where the exists bit is clear: kernel G'' over the
        stacked group, cached by fragment generation beside the leaves and
        registered with the residency LRU (JAX plan.py:512).  Under a pin
        that has diverged from the live fragments the decode is returned
        without being published.  The span storage.leaf."""
        with TRACER.span("storage.leaf"):
            shards = self.layout(index.name, shards)
            f = index.field(fname)

            def walk():
                frags = [self._frag(f, view_bsi_group(fname), s)
                         for s in shards]
                return frags, _generations(frags), None

            def decode(_):
                bsi = self.stacked_bsi(index, fname, depth, shards)
                return bsi.map(ck.bsi_decode) if isinstance(bsi, Sharded) \
                    else ck.bsi_decode(bsi)
            return self._cached(
                ("vals", index.name, fname, depth, tuple(shards)), index,
                f or index, walk, decode)

    def stacked_full(self, index: Index, shards: List[int]):
        """(S, W) all-ones filter (zero on a mesh's padding rows).  The
        span storage.leaf."""
        with TRACER.span("storage.leaf"):
            return self._gather(index, _Leaf("full"),
                                self.layout(index.name, shards))

    # -- plan execution -----------------------------------------------------

    def _run(self, index: Index, plan: BitmapPlan, shards: List[int],
             want_words: bool, want_counts: bool):
        """(words, counts) of kernel A over the stacked leaves; on a mesh
        (a list of them, one launch per local member on its block, and the
        layout)."""
        shards = self.layout(index.name, shards)
        leaves = [self._gather_leaf(index, l, shards) for l in plan.leaves]

        def words(prog: ck.Program) -> torch.Tensor:
            return ck.plan_eval(prog, want_words=True)[0]

        def lower(leaves, S: int) -> ck.Program:
            with TRACER.span("plan.lower"):
                return lower_ir(plan.ir, leaves, plan.params, S, words)
        if self.mesh is None:
            return ck.plan_eval(lower(leaves, len(shards)), want_words,
                                want_counts)
        B = len(shards) // self.mesh.size
        return [ck.plan_eval(lower([l.blocks[k] for l in leaves], B),
                             want_words, want_counts)
                for k in range(len(self.mesh.local))], shards

    def run_bitmap(self, index: Index, plan: BitmapPlan, shards: List[int]):
        """Stacked (S, W) int32 result words; on a mesh the Sharded
        (S_pad, W) words, padding rows zero (JAX plan.py's run_bitmap and
        run_words_padded in one)."""
        if self.mesh is None:
            words, _ = self._run(index, plan, shards, True, False)
            return words
        outs, lay = self._run(index, plan, shards, True, False)
        return Sharded(self.mesh, lay, [w for w, _ in outs])

    def run_count(self, index: Index, plan: BitmapPlan, shards: List[int]
                  ) -> int:
        """Fused plan + popcount: the result words never reach HBM.  On a
        mesh one kernel-A launch per member, then total_count's merge."""
        if self.mesh is None:
            _, counts = self._run(index, plan, shards, False, True)
            return int(to_host(counts.sum()))
        from featurebase_tpu_torch.parallel import agg
        outs, _ = self._run(index, plan, shards, False, True)
        total = agg._psum(self.mesh, [c.sum() for _, c in outs])
        with TRACER.span("device.wait"):
            return int(total)
