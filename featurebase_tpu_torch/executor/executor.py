"""The query executor: PQL call tree -> plan kernels on the GPU.

Counterpart of featurebase_tpu/executor/executor.py (reference
executor.go:183 Execute, 679-846 executeCall dispatch).  Ported call
families: bitmap calls that the plan compiler accepts (Row, Range, Union,
Intersect, Difference, Xor, Not, All, Shift, ConstRow), Count, TopN/TopK,
Sum, Min/Max, MinRow/MaxRow and Options(shards=).  Every other family, and
an aggregate filter the plan compiler refuses, raises NotImplementedError.

Kernels by family: bitmap calls, Count and every aggregate filter run
kernel A (``plan_eval``); TopN and MinRow/MaxRow kernel B (``row_counts``);
Sum kernel C (``bsi_sum_planes``); Min/Max kernel D (``bsi_min_max``)
(ops/cuda_kernels.py).

Device rule: ``Executor(holder)`` runs on CUDA and raises when CUDA is
unavailable; the CPU runs only when the caller asks for it with
``device="cpu"`` (the tests do).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import WORDS_PER_ROW
from featurebase_tpu_torch.executor.plan import (BitmapPlan, PlanCompiler,
                                                 PlanError, PlanExecutor)
from featurebase_tpu_torch.executor.results import (Pair, PairField,
                                                    PairsField, ValCount)
from featurebase_tpu_torch.model.field import (CACHE_NONE, TYPE_BOOL,
                                               TYPE_DECIMAL, TYPE_TIME,
                                               TYPE_TIMESTAMP, Field)
from featurebase_tpu_torch.model.index import Holder, Index
from featurebase_tpu_torch.model.row import Row
from featurebase_tpu_torch.model.view import VIEW_STANDARD
from featurebase_tpu_torch.ops import bitwise as bw
from featurebase_tpu_torch.ops import bsi as bsiops
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.parallel.agg import finalize_sum
from featurebase_tpu_torch.pql.ast import Call
from featurebase_tpu_torch.pql.parser import parse as pql_parse


class ExecError(Exception):
    pass


class FieldNotFound(ExecError):
    pass


# call families of featurebase_tpu's executor that this package does not run
_NOT_PORTED = {
    "Set": "Set", "Clear": "Clear", "ClearRow": "ClearRow", "Store": "Store",
    "Delete": "Delete", "Percentile": "Percentile", "Var": "Var/Corr", "Corr": "Var/Corr",
    "Rows": "Rows", "GroupBy": "GroupBy", "Extract": "Extract",
    "Distinct": "Distinct", "IncludesColumn": "IncludesColumn",
    "FieldValue": "FieldValue", "Sort": "Sort", "UnionRows": "UnionRows",
    "Limit": "Limit", "Apply": "Apply", "Arrow": "Arrow",
    "ExternalLookup": "ExternalLookup",
}


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """CUDA unless the caller names another device; never a silent CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _not_ported(family: str):
    return NotImplementedError(f"{family} is not ported yet")


class Executor:
    """Single-controller executor over a Holder."""

    # cap on the stacked TopN tile (a per-shard loop runs above it)
    ROWS_STACKED_MAX_BYTES = 256 << 20

    def __init__(self, holder: Holder, device=None):
        self.holder = holder
        self.device = resolve_device(device)
        self.plan_executor = PlanExecutor(holder, self.device)

    # ------------------------------------------------------------------ API

    def execute(self, index_name: str, query,
                shards: Optional[List[int]] = None) -> List[Any]:
        """Execute a PQL query string or pql.Query; returns a result per
        top-level call, read from one pinned snapshot of the index."""
        index = self.holder.index(index_name)
        if index is None:
            raise ExecError(f"index not found: {index_name}")
        if isinstance(query, str):
            query = pql_parse(query)
        from featurebase_tpu_torch.model import snapshot
        pin = snapshot.pin_index(index)
        try:
            with snapshot.pinned(pin):
                results = []
                for call in query.calls:
                    self._validate_call(index, call)
                    c = self._pre_translate(index, call)
                    result = self._execute_call(index, c, shards)
                    results.append(self._translate_result(index, c, result))
                return results
        finally:
            snapshot.release(pin)

    def _validate_call(self, index: Index, call: Call):
        """Unknown field names error regardless of data presence."""
        if call.name in ("Row", "Range", "Sum", "Min", "Max", "MinRow",
                         "MaxRow", "TopN", "TopK"):
            fld = call.args.get("_field") or call.args.get("field")
            if fld is None and call.name in ("Row", "Range"):
                fld, _ = call.field_arg()
            if fld is not None:
                self._field_or_err(index, fld)
        for ch in call.children:
            self._validate_call(index, ch)
        for v in call.args.values():
            if isinstance(v, Call):
                self._validate_call(index, v)

    def _field_or_err(self, index: Index, name: str) -> Field:
        f = index.field(name)
        if f is None:
            raise FieldNotFound(f"field not found: {name}")
        return f

    # ------------------------------------------------- key pre-translation

    def _pre_translate(self, index: Index, call: Call) -> Call:
        """Convert string row keys to IDs in place (reference
        executor.go:6814 preTranslate; reads only)."""
        if index.options.keys and call.name == "ConstRow":
            cols_arg = call.args.get("columns")
            if isinstance(cols_arg, list) and \
                    any(isinstance(c, str) for c in cols_arg):
                found = index.translate_store.find_keys(
                    [c for c in cols_arg if isinstance(c, str)])
                call.args["columns"] = [
                    found.get(c, -1) if isinstance(c, str) else c
                    for c in cols_arg]
        for k, v in list(call.args.items()):
            f = index.field(k)
            if f is None:
                continue
            if isinstance(v, str) and f.options.keys:
                call.args[k] = index.row_translation(k).find_keys(
                    [v]).get(v, -1)
            elif isinstance(v, bool) and f.options.type == TYPE_BOOL:
                call.args[k] = 1 if v else 0
            elif isinstance(v, str) and not f.is_bsi():
                raise ExecError(f"string row key on unkeyed field {k!r}")
        for i, ch in enumerate(call.children):
            call.children[i] = self._pre_translate(index, ch)
        for k, v in list(call.args.items()):
            if isinstance(v, Call):
                call.args[k] = self._pre_translate(index, v)
        return call

    def _translate_result(self, index: Index, call: Call, result):
        """IDs -> keys on results (reference executor.go:7519)."""
        if isinstance(result, Row) and index.options.keys:
            cols = result.columns()
            keys = index.translate_store.translate_ids(cols)
            result.keys = [k if k is not None else int(c)
                           for k, c in zip(keys, cols)]
        if isinstance(result, PairsField):
            f = index.field(result.field)
            if f is not None and f.options.keys:
                store = index.row_translation(result.field)
                for p in result.pairs:
                    p.key = store.translate_ids([p.id])[0]
        return result

    # ------------------------------------------------------- call dispatch

    def _execute_call(self, index: Index, call: Call,
                      shards: Optional[List[int]]):
        name = call.name
        if name == "Options":
            # Options(call, shards=[...]) restricts execution to the listed
            # shards (reference: executor.go Options -> opt.Shards)
            opt_shards = call.args.get("shards")
            if opt_shards is not None:
                opt_shards = [int(s) for s in opt_shards]
                if shards is not None:
                    opt_shards = sorted(set(opt_shards) & set(shards))
                shards = opt_shards
            return self._execute_call(index, call.children[0], shards)
        if name == "Count":
            return self._execute_count(index, call, shards)
        if name in ("TopN", "TopK"):
            return self._execute_topn(index, call, shards)
        if name == "Sum":
            return self._execute_sum(index, call, shards)
        if name in ("Min", "Max"):
            return self._execute_min_max(index, call, shards,
                                         is_min=name == "Min")
        if name in ("MinRow", "MaxRow"):
            return self._execute_min_max_row(index, call, shards,
                                             is_min=name == "MinRow")
        if name in _NOT_PORTED:
            raise _not_ported(_NOT_PORTED[name])
        return self._execute_bitmap_call(index, call, shards)

    def _shards(self, index: Index, shards: Optional[List[int]]
                ) -> List[int]:
        return list(shards) if shards is not None else \
            index.available_shards()

    def _compile(self, index: Index, call: Call) -> BitmapPlan:
        """Compile a bitmap call; unplannable calls need the per-shard
        interpreter, which is not ported."""
        if call.name in _NOT_PORTED:
            raise _not_ported(_NOT_PORTED[call.name])
        try:
            return PlanCompiler(index).compile(call)
        except PlanError as e:
            raise NotImplementedError(
                f"per-shard bitmap path is not ported yet ({e})") from e

    # ----------------------------------------------------- bitmap calls

    def _execute_bitmap_call(self, index: Index, call: Call,
                             shards: Optional[List[int]]) -> Row:
        if call.name == "All" and ("limit" in call.args
                                   or "offset" in call.args):
            raise _not_ported("Limit")
        plan = self._compile(index, call)
        shard_list = self._shards(index, shards)
        if not shard_list:
            return Row()
        stacked = self.plan_executor.run_bitmap(index, plan, shard_list)
        return Row({s: stacked[i] for i, s in enumerate(shard_list)})

    def _mesh_filter(self, index: Index, filt_call: Optional[Call],
                     shards: List[int]) -> torch.Tensor:
        """Stacked (S, W) filter words (the JAX package's mesh-aggregate
        filter, here on one device): all ones with no filter, else the
        plan-compiled filter in word mode."""
        if filt_call is None:
            return self.plan_executor.stacked_full(index, shards)
        plan = self._compile(index, filt_call)
        return self.plan_executor.run_bitmap(index, plan, shards)

    # ------------------------------------------------------------- Count

    def _execute_count(self, index: Index, call: Call,
                       shards: Optional[List[int]]) -> int:
        """Count(bitmap) (reference executeCount executor.go:5839): the plan
        and its popcount run fused in kernel A."""
        if not call.children:
            raise ExecError("Count() requires a child call")
        plan = self._compile(index, call.children[0])
        shard_list = self._shards(index, shards)
        if not shard_list:
            return 0
        return self.plan_executor.run_count(index, plan, shard_list)

    # ------------------------------------------------------- TopN / TopK

    def _execute_topn(self, index: Index, call: Call,
                      shards: Optional[List[int]]) -> PairsField:
        """Exact TopN/TopK: per-row fused intersection counts per shard,
        merged by row id (reference: TopN executor.go:2779; TopK
        executor.go:2357 exact path)."""
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        n = call.args.get("n") or call.args.get("k") or 0
        filt_call = call.children[0] if call.children else None
        if filt_call is None and isinstance(call.args.get("filter"), Call):
            filt_call = call.args["filter"]  # TopK's named filter arg
        from_t, to_t = call.args.get("from"), call.args.get("to")
        if f.options.type == TYPE_TIME and (from_t or to_t):
            from datetime import datetime

            from featurebase_tpu_torch.model.timequantum import parse_time
            lo = parse_time(from_t) if from_t else datetime(1, 1, 1)
            hi = parse_time(to_t) if to_t else datetime(9999, 1, 1)
            view_names = f.views_for_range(lo, hi)
        else:
            view_names = [VIEW_STANDARD]

        # unfiltered TopN serves per-shard counts from the field's rank
        # cache when fragment generations match (reference: cache.go:25)
        use_cache = filt_call is None and f.options.cache_type != CACHE_NONE
        counts: Dict[int, int] = {}
        names = tuple(view_names)
        missing: List[int] = []
        miss_gens: Dict[int, tuple] = {}
        for shard in self._shards(index, shards):
            if use_cache:
                gens = tuple(fr.generation for vn in names
                             if (vv := f.view(vn)) is not None
                             and (fr := vv.fragment(shard)) is not None)
                hit = f._topn_cache.get((shard, names))
                if hit is not None and hit[0] == gens:
                    for rid, c in hit[1].items():
                        counts[rid] = counts.get(rid, 0) + c
                    continue
                miss_gens[shard] = gens
            missing.append(shard)
        if missing:
            self._topn_count_shards(index, f, names, filt_call, missing,
                                    miss_gens, use_cache, counts)
        pairs = [Pair(id=rid, count=c) for rid, c in counts.items()]
        pairs.sort(key=lambda p: (-p.count, p.id))
        if n:
            pairs = pairs[: int(n)]
        return PairsField(pairs, fld)

    def _topn_count_shards(self, index: Index, f: Field, names, filt_call,
                           missing: List[int], miss_gens: Dict[int, tuple],
                           use_cache: bool, counts: Dict[int, int]):
        """Per-row counts for cache-missing shards with kernel B: one
        stacked (S, R, W) launch over all of them, or a launch per shard
        when the stacked tile would exceed ROWS_STACKED_MAX_BYTES.  Complete
        per-shard count sets refresh the rank cache."""
        def add_shard(shard, row_ids, pc):
            shard_counts = {rid: int(c) for rid, c in zip(row_ids, pc) if c}
            for rid, c in shard_counts.items():
                counts[rid] = counts.get(rid, 0) + c
            if use_cache and len(shard_counts) <= f.options.cache_size:
                f._topn_cache[(shard, names)] = \
                    (miss_gens[shard], shard_counts)

        def frags_of(shard):
            return [fr for vn in names if (vv := f.view(vn)) is not None
                    and (fr := vv.fragment(shard)) is not None]

        row_ids = sorted({int(r) for s in missing for fr in frags_of(s)
                          for r in fr.row_ids()})
        if not row_ids:
            return
        pe = self.plan_executor
        tile_bytes = len(row_ids) * len(missing) * WORDS_PER_ROW * 4
        if tile_bytes <= self.ROWS_STACKED_MAX_BYTES:
            tiles = pe.stacked_field_rows(index, f.name, names,
                                          tuple(row_ids), missing)
            if filt_call is None:
                pc = bw.per_shard_row_counts(tiles)
            else:
                filt = self._mesh_filter(index, filt_call, missing)
                pc = bw.per_shard_filtered_row_counts(tiles, filt)
            pc = pc.cpu().numpy()
            for si, shard in enumerate(missing):
                add_shard(shard, row_ids, pc[si])
            return
        for shard in missing:
            frags = frags_of(shard)
            srows = sorted({int(r) for fr in frags for r in fr.row_ids()})
            if not srows:
                continue
            tile = pe.stacked_field_rows(index, f.name, names, tuple(srows),
                                         [shard])[0]
            if filt_call is not None:
                fw = self._mesh_filter(index, filt_call, [shard])
                pc1 = bw.count_and_rows(tile, fw)
            else:
                pc1 = bw.popcount_rows(tile)
            add_shard(shard, srows, pc1.cpu().numpy())

    # ----------------------------------------------------- Sum / Min / Max

    def _agg_inputs(self, index: Index, call: Call):
        fld = call.args.get("_field") or call.args.get("field")
        if fld is None:
            raise ExecError(f"{call.name}() requires a field")
        f = self._field_or_err(index, fld)
        filt_call = call.children[0] if call.children else None
        return f, filt_call

    def _agg_group(self, index: Index, f: Field, filt_call: Optional[Call],
                   shards: List[int]):
        """The field's stacked BSI group at max(bit_depth, 1) planes and the
        stacked filter over `shards`."""
        filt = self._mesh_filter(index, filt_call, shards)
        group = self.plan_executor.stacked_bsi(index, f.name,
                                               max(f.bit_depth, 1), shards)
        return group, filt

    @staticmethod
    def _wrap_valcount(f: Field, val: int, count: int) -> ValCount:
        vc = ValCount(val=val, count=count)
        if f.options.type == TYPE_DECIMAL:
            vc.float_val = val / (10 ** f.options.scale)
            vc.decimal_val = vc.float_val
        elif f.options.type == TYPE_TIMESTAMP:
            vc.timestamp_val = val
        return vc

    def _execute_sum(self, index: Index, call: Call,
                     shards: Optional[List[int]]) -> ValCount:
        """Sum (reference executor.go Sum; JAX executor.py:1158): one
        kernel-C launch over every shard, finished exactly on the host."""
        f, filt_call = self._agg_inputs(index, call)
        shard_list = self._shards(index, shards)
        if not shard_list:
            return self._wrap_valcount(f, 0, 0)
        group, filt = self._agg_group(index, f, filt_call, shard_list)
        D = group.shape[1] - 2
        parts = ck.bsi_sum_planes(group, filt).cpu().numpy()
        count = int(parts[2 * D])
        total = finalize_sum(parts[:D], parts[D:2 * D]) + f.base * count
        return self._wrap_valcount(f, total, count)

    def _execute_min_max(self, index: Index, call: Call,
                         shards: Optional[List[int]], is_min: bool
                         ) -> ValCount:
        """Min/Max (JAX executor.py:1199): one kernel-D launch over every
        shard.  Up to depth 31 the answer has min_max_stacked's semantics;
        deeper, the reference's per-shard min_host/max_host merged with
        ValCount.smaller/larger (ops/bsi.py)."""
        f, filt_call = self._agg_inputs(index, call)
        shard_list = self._shards(index, shards)
        if not shard_list:
            return self._wrap_valcount(f, 0, 0)
        group, filt = self._agg_group(index, f, filt_call, shard_list)
        parts = ck.bsi_min_max(group, filt).cpu().numpy()
        if max(f.bit_depth, 1) <= 31:
            v, c = bsiops.min_max_stacked_finish(parts, is_min)
            if c == 0:
                return self._wrap_valcount(f, 0, 0)
            return self._wrap_valcount(f, v + f.base, c)
        acc = ValCount()
        for v, c in bsiops.min_max_per_shard(parts, is_min):
            if c == 0:
                continue
            vc = ValCount(v + f.base, c)
            acc = acc.smaller(vc) if is_min else acc.larger(vc)
        return self._wrap_valcount(f, acc.val, acc.count)

    def _execute_min_max_row(self, index: Index, call: Call,
                             shards: Optional[List[int]], is_min: bool
                             ) -> PairField:
        """MinRow/MaxRow (reference executor.go:1604,1643; JAX
        executor.py:1238): per shard, the row counts of the fragment's
        device tile with kernel B, unfiltered; the smallest (largest) row
        with a set bit.  Ties across shards add counts.  The counts of
        every shard are fetched once, after the loop."""
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        v = f.view(VIEW_STANDARD)
        per_shard = []
        for shard in self._shards(index, shards):
            frag = v.fragment(shard) if v else None
            if frag is None or frag.num_rows == 0:
                continue
            tile = frag.device_tile(self.device)
            slot_rows = frag.slot_rows()[: tile.shape[0]]
            per_shard.append((slot_rows, ck.row_counts(tile[None])[0]))
        counts = torch.cat([c for _, c in per_shard]).cpu().numpy() \
            if per_shard else None
        best_row, best_count, at = None, 0, 0
        for slot_rows, c in per_shard:
            rows = np.array(slot_rows, dtype=np.int64)
            cnt = counts[at:at + c.numel()]
            at += c.numel()
            nz = cnt > 0
            if not nz.any():
                continue
            cand, ccnt = rows[nz], cnt[nz]
            pick = int(cand.min()) if is_min else int(cand.max())
            n = int(ccnt[cand == pick][0])
            if best_row is None or (is_min and pick < best_row) or \
                    (not is_min and pick > best_row):
                best_row, best_count = pick, n
            elif pick == best_row:
                best_count += n
        return PairField(Pair(id=best_row or 0, count=best_count), fld)
