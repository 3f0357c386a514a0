"""The query executor: PQL call tree -> plan kernels on the GPU.

Counterpart of featurebase_tpu/executor/executor.py (reference
executor.go:183 Execute, 679-846 executeCall dispatch).  Ported call
families: every bitmap call (Row, Range, Union, Intersect, Difference, Xor,
Not, All, Shift, ConstRow, Rows, UnionRows, Limit), Count, TopN/TopK,
Sum, Min/Max, MinRow/MaxRow, Rows, GroupBy, Distinct (also under Count, as
a bitmap operand and as GroupBy's aggregate=Count(Distinct(...))),
Percentile, Sort, Extract, IncludesColumn, FieldValue, Var, Corr,
Options(shards=), the writes Set, Clear, ClearRow, Store and Delete,
Apply, Arrow and ExternalLookup: every call family of the JAX package's
executor.  ``enforce_memory_limit`` holds a query to the API's
max-query-memory.

Calls the plan compiler accepts run over stacked (S, W) shard tiles; the
rest (Row(f=null), Rows, UnionRows or Limit as an operand) run through the
per-shard interpreter (``_bitmap_call_shard``, reference
executeBitmapCallShard executor.go:1782), which keeps each shard's words on
the device, and every aggregate whose filter the compiler refuses goes per
shard too, with one fetch after the loop.

Kernels by family: bitmap calls, Count and every plannable filter run
kernel A (``plan_eval``), as do the interpreter's BSI rows (at S = 1) and
its counts; TopN, MinRow/MaxRow, Rows and one-dimension GroupBy kernel B
(``row_counts``); Sum kernel C' (``bsi_sum_planes``); Min/Max kernel D'
(``bsi_min_max``); GroupBy's pair counts kernel E (``pair_counts``) and
its sums kernel F (``bsi_sum_groups``) (ops/cuda_kernels.py), one launch
over every shard (a residency batch) where the reference's per-shard loop
would take its one-shot product or run its per-shard Sum or Min/Max.
Decoded values come from kernel G''
(``bsi_decode``: Distinct, Sort and Percentile over the cached stacked
decode, PlanExecutor.stacked_vals; under a filter the plan compiler
refuses, ``bsi_decode_sharded`` over every shard's mirror), Extract's from
kernel G''' (``bsi_decode_gather_sharded``, one launch over every shard's
matched columns), and Percentile's bisection counts from kernel I
(``percentile_counts``), each one launch a residency batch; a field deeper
than 31 planes decodes on the host in int64 (Field.values_dense_host), and
its Percentile bisects over kernel-A Counts.  Apply's columnar route
takes Extract's: one kernel-A plan for its filter and one kernel-G''' launch
a BSI field and residency batch.  Var and Corr under a filter
the plan compiler takes run kernel H (``var_moments``, ``corr_moments``)
over the stacked groups, one launch a query; otherwise, or past depth 31,
they sum in float64 on the host, as the reference does.

Writes change the host masters (model/fragment.py) and run under the
index's mutate gate, not a snapshot pin; every device cache follows them
by fragment generation (the plan executor's leaves and decodes, the rank
cache) or by dirty slots (the fragment mirrors).  A fragment's generations
start at a base no other fragment shares, so a field or index deleted and
created again never meets the old one's cache entries; the delete itself
drops them (Index.delete_field, Holder.delete_index).

On a mesh (``Executor(holder, mesh=...)``, parallel/mesh.py) the stacked
entries are Sharded over the members, each member's kernel runs on its own
block of shards, and every family merges the members' partials once
(parallel/agg.py): Count, Sum, TopN, GroupBy, Rows and set-field Distinct
through the agg programs (kernels A, B', C', E', F'); Min/Max, Percentile,
Var/Corr, BSI Distinct, Sort and Extract with a launch a member of the
kernel they use (D', I', H', G'' and G''') and an exact host merge (the
families the JAX package runs through GSPMD).  Where the filter does not
plan, a family takes its per-shard route on the executor's device, the
mesh's first local member, as the JAX package does.  Results that need
every member's block (bitmap rows, Extract) raise on a mesh that spans
processes.

Device rule: ``Executor(holder)`` runs on CUDA and raises when CUDA is
unavailable; the CPU runs only when the caller asks for it with
``device="cpu"`` (the tests do), or with a mesh of CPU members.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import (BSI_EXISTS_ROW, BSI_OFFSET,
                                               BSI_SIGN_ROW, SHARD_WIDTH,
                                               WORDS_PER_ROW)
from featurebase_tpu_torch.executor.plan import (BitmapPlan, PlanCompiler,
                                                 PlanError, PlanExecutor,
                                                 to_host)
from featurebase_tpu_torch.executor.qcontext import check_interrupt
from featurebase_tpu_torch.executor.results import (ExtractedTable,
                                                    ExtractedTableColumn,
                                                    ExtractedTableField,
                                                    FieldRow, GroupCount,
                                                    Pair, PairField,
                                                    PairsField, ValCount)
from featurebase_tpu_torch.model.field import (CACHE_NONE, TYPE_BOOL,
                                               TYPE_DECIMAL, TYPE_INT,
                                               TYPE_MUTEX, TYPE_SET,
                                               TYPE_TIME, TYPE_TIMESTAMP,
                                               Field)
from featurebase_tpu_torch.model.index import Holder, Index
from featurebase_tpu_torch.model.row import Row, SignedRow, host_words
from featurebase_tpu_torch.model.view import VIEW_STANDARD, view_bsi_group
from featurebase_tpu_torch.ops import bitwise as bw
from featurebase_tpu_torch.ops import bsi as bsiops
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import decode
from featurebase_tpu_torch.parallel import agg
from featurebase_tpu_torch.parallel.agg import finalize_sum
from featurebase_tpu_torch.pql.ast import WRITE_CALLS, Call, Condition
from featurebase_tpu_torch.pql.parser import parse as pql_parse
from featurebase_tpu_torch.utils.pool import map_shards
from featurebase_tpu_torch.utils.tracing import TRACER


class ExecError(Exception):
    pass


class FieldNotFound(ExecError):
    pass


# a shard's decode (kernel G''): 4 bytes a column, 32 rows of W words, held
# against the residency budget beside the mirrors a launch reads
DECODE_ROWS = 32
# the Sort route's rows a shard: the decode, its present mask (a byte a
# column) and decode.sort_stacked's int64 temporaries (64 rows each, at most
# four alive at once)
SORT_ROWS = DECODE_ROWS + 8 + 4 * 64


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """CUDA unless the caller names another device; never a silent CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _time_views(f: Field, call: Call) -> List[str]:
    """The views a call reads: the time views its from=/to= cover on a time
    field, else the standard view."""
    from_t, to_t = call.args.get("from"), call.args.get("to")
    if f.options.type == TYPE_TIME and (from_t or to_t):
        from datetime import datetime

        from featurebase_tpu_torch.model.timequantum import parse_time
        lo = parse_time(from_t) if from_t else datetime(1, 1, 1)
        hi = parse_time(to_t) if to_t else datetime(9999, 1, 1)
        return f.views_for_range(lo, hi)
    return [VIEW_STANDARD]


def _fetch(parts: List[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of device tensors in one transfer a device (the
    per-shard loops fetch once, after the loop; a mesh's members may sit on
    several cards).  The span device.wait."""
    out: List[Optional[np.ndarray]] = [None] * len(parts)
    by_dev: Dict[torch.device, List[int]] = {}
    for i, p in enumerate(parts):
        by_dev.setdefault(p.device, []).append(i)
    for idx in by_dev.values():
        host = to_host(torch.cat([parts[i].reshape(-1).to(torch.int64)
                                  for i in idx]))
        at = 0
        for i in idx:
            n = parts[i].numel()
            out[i] = host[at:at + n].reshape(parts[i].shape)
            at += n
    return out


def _members(fn, *arrs) -> list:
    """fn over the same local block of each Sharded array, a member at a
    time (one launch a member)."""
    return [fn(*blocks) for blocks in zip(*(a.blocks for a in arrs))]


class Executor:
    """Single-controller executor over a Holder."""

    # cap on the stacked TopN and Rows tiles (a per-shard loop runs above it)
    ROWS_STACKED_MAX_BYTES = 256 << 20
    # one-shot GroupBy limits: entries of the fused pair-count matrix, and
    # bytes of materialized combination masks
    GROUPBY_ONESHOT_MAX_COUNTS = 1 << 16
    GROUPBY_ONESHOT_MAX_MASK_BYTES = 64 << 20

    def __init__(self, holder: Holder, device=None, mesh=None):
        self.holder = holder
        if mesh is not None and device is None:
            device = mesh.local_devices[0]
        self.device = resolve_device(device)
        self.plan_executor = PlanExecutor(holder, self.device, mesh=mesh)

    @property
    def mesh(self):
        return self.plan_executor.mesh

    # ------------------------------------------------------------------ API

    def execute(self, index_name: str, query,
                shards: Optional[List[int]] = None) -> List[Any]:
        """Execute a PQL query string or pql.Query; returns a result per
        top-level call.  A query that writes runs under the index's mutate
        gate, shared with other writers; any other reads one pinned
        snapshot of the index (model/snapshot.py).  The span
        executor.execute: the gate or the pin, and each call's checks and
        key translations, beside its calls' spans."""
        index = self.holder.index(index_name)
        if index is None:
            raise ExecError(f"index not found: {index_name}")
        if isinstance(query, str):
            query = pql_parse(query)

        def run():
            results = []
            for call in query.calls:
                self._validate_call(index, call)
                c = self._pre_translate(index, call)
                result = self._execute_call(index, c, shards)
                results.append(self._translate_result(index, c, result))
            return results

        with TRACER.span("executor.execute"):
            return self._gated(index, query, run)

    def _gated(self, index: Index, query, run):
        """run() under the index's mutate gate, shared with other writers,
        when the query writes; else under one pinned snapshot."""
        if any(c.name in WRITE_CALLS for c in query.calls):
            # writers run shared: per-fragment locks serialize the
            # mutation, and pinned readers never exclude them (reference:
            # one-writer RBF Tx with MVCC readers, rbf/db.go:607)
            with index.mutate_gate.shared():
                return run()
        from featurebase_tpu_torch.model import snapshot
        pin = snapshot.pin_index(index)
        try:
            with snapshot.pinned(pin):
                return run()
        finally:
            snapshot.release(pin)

    def execute_remote(self, index_name: str, query,
                       shards: Optional[List[int]]) -> List[Any]:
        """A coordinator-translated call list over an explicit shard subset:
        the raw, untranslated partials, for the cluster's merge (reference:
        the remote leg of mapReduce, Remote=true, executor.go:6392).  Gated
        as execute is.  A call with _byShard answers {"byShard": {shard:
        partial}}."""
        index = self.holder.index(index_name)
        if index is None:
            raise ExecError(f"index not found: {index_name}")
        if isinstance(query, str):
            query = pql_parse(query)

        def one(call):
            if not call.args.get("_byShard"):
                return self._execute_call(index, call, shards)
            # a result whose order is the shards' (Apply's values, Arrow's
            # rows): one partial a shard, for the coordinator to order
            c = Call(call.name, {k: v for k, v in call.args.items()
                                 if k != "_byShard"}, call.children)
            return {"byShard": {str(s): self._execute_call(index, c, [s])
                                for s in self._shards(index, shards)}}
        return self._gated(index, query,
                           lambda: [one(call) for call in query.calls])

    def _validate_call(self, index: Index, call: Call):
        """Unknown field names error regardless of data presence."""
        if call.name in ("Row", "Range", "Rows", "Sum", "Min", "Max",
                         "MinRow", "MaxRow", "Distinct", "TopN", "TopK",
                         "Percentile", "Sort", "FieldValue", "Set", "Clear",
                         "Store", "ClearRow"):
            fld = call.args.get("_field") or call.args.get("field")
            if fld is None and call.name in ("Row", "Range", "Set", "Clear",
                                             "Store", "ClearRow"):
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
        """Convert string keys to IDs in place (reference executor.go:6814
        preTranslate / translateCall:7215): a write creates the column,
        row and foreign-index keys it names, a read only finds them."""
        is_write = call.name in WRITE_CALLS
        col = call.args.get("_col")
        if isinstance(col, str):
            if not index.options.keys:
                raise ExecError("string column key on unkeyed index")
            if is_write:
                call.args["_col"] = index.translate_store.create_keys(
                    [col])[col]
            else:
                call.args["_col"] = index.translate_store.find_keys(
                    [col]).get(col, -1)
        if index.options.keys:
            cols_arg = call.args.get("columns")
            if call.name == "ConstRow" and isinstance(cols_arg, list) and \
                    any(isinstance(c, str) for c in cols_arg):
                found = index.translate_store.find_keys(
                    [c for c in cols_arg if isinstance(c, str)])
                call.args["columns"] = [
                    found.get(c, -1) if isinstance(c, str) else c
                    for c in cols_arg]
            colf = call.args.get("column")
            if isinstance(colf, str):   # Rows(f, column=<record key>)
                call.args["column"] = index.translate_store.find_keys(
                    [colf]).get(colf, -1)
        for k, v in list(call.args.items()):
            f = index.field(k)
            if f is None:
                continue
            if isinstance(v, str) and f.options.keys:
                store = index.row_translation(k)
                call.args[k] = store.create_keys([v])[v] if is_write else \
                    store.find_keys([v]).get(v, -1)
            elif isinstance(v, str) and f.options.foreign_index:
                # a foreign-index field's string values are record keys of
                # the index it references (reference translationStrategy
                # executor.go:7548)
                fidx = self.holder.index(f.options.foreign_index)
                if fidx is None:
                    raise ExecError(
                        f"foreign index not found: {f.options.foreign_index}")
                store = fidx.translate_store
                call.args[k] = store.create_keys([v])[v] if is_write else \
                    store.find_keys([v]).get(v, -1)
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
        if isinstance(result, Row) and call.name == "Distinct":
            # Distinct's bitmap holds field values, not records: a keyed
            # field's ids translate through its row store, an unkeyed
            # field's stay numeric on a keyed index
            fld = call.args.get("_field") or call.args.get("field")
            f = index.field(fld) if fld else None
            if f is not None and f.options.keys:
                ids = [int(c) for c in result.columns()]
                keys = index.row_translation(fld).translate_ids(ids)
                result.keys = [k if k is not None else i
                               for k, i in zip(keys, ids)]
            return result
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
        if isinstance(result, list) and result and \
                isinstance(result[0], GroupCount):
            for gc in result:
                for fr in gc.group:
                    f = index.field(fr.field)
                    if f is not None and f.options.keys and fr.value is None:
                        store = index.row_translation(fr.field)
                        fr.row_key = store.translate_ids([fr.row_id])[0]
        if isinstance(result, dict) and call.name == "Sort" and \
                "columns" in result and index.options.keys:
            # sorted record ids translate to record keys
            cols = result["columns"]
            keys = index.translate_store.translate_ids(cols)
            result["columns"] = [k if k is not None else c
                                 for k, c in zip(keys, cols)]
        if isinstance(result, list) and call.name == "Rows":
            # keyed fields return row keys (reference RowIdentifiers.Keys)
            fld = call.args.get("_field") or call.args.get("field")
            f = index.field(fld) if fld else None
            if f is not None and f.options.keys:
                keys = index.row_translation(fld).translate_ids(
                    [int(r) for r in result])
                return [k if k is not None else int(r)
                        for k, r in zip(keys, result)]
        return result

    # ------------------------------------------------------- call dispatch

    def _execute_call(self, index: Index, call: Call,
                      shards: Optional[List[int]]):
        """One call, as the span executor.execute<Call> (utils/tracing.py:
        a node of a profiled query's tree, and recorded under the
        profiler)."""
        check_interrupt()
        with TRACER.start_span("executor.execute", call.name):
            return self._execute_call_inner(index, call, shards)

    def _execute_call_inner(self, index: Index, call: Call,
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
        if name == "Set":
            return self._execute_set(index, call)
        if name == "Clear":
            return self._execute_clear(index, call)
        if name == "ClearRow":
            return self._execute_clear_row(index, call, shards)
        if name == "Store":
            return self._execute_store(index, call, shards)
        if name == "Delete":
            return self._execute_delete(index, call, shards)
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
        if name == "Rows":
            return self._execute_rows(index, call, shards)
        if name == "GroupBy":
            return self._execute_group_by(index, call, shards)
        if name == "UnionRows":
            return self._execute_union_rows(index, call, shards)
        if name == "Limit":
            return self._execute_limit(index, call, shards)
        if name == "Distinct":
            return self._execute_distinct(index, call, shards)
        if name == "Percentile":
            return self._execute_percentile(index, call, shards)
        if name == "Sort":
            return self._execute_sort(index, call, shards)
        if name == "Extract":
            return self._execute_extract(index, call, shards)
        if name == "IncludesColumn":
            return self._execute_includes_column(index, call)
        if name == "FieldValue":
            return self._execute_field_value(index, call)
        if name == "Var":
            return self._execute_var(index, call, shards)
        if name == "Corr":
            return self._execute_corr(index, call, shards)
        if name == "Apply":
            return self._execute_apply(index, call, shards)
        if name == "Arrow":
            return self._execute_arrow(index, call, shards)
        if name == "ExternalLookup":
            return self._execute_external_lookup(index, call, shards)
        return self._execute_bitmap_call(index, call, shards)

    def _shards(self, index: Index, shards: Optional[List[int]]
                ) -> List[int]:
        return list(shards) if shards is not None else \
            index.available_shards()

    def _try_compile(self, index: Index, call: Call) -> Optional[BitmapPlan]:
        """The stacked plan of a bitmap call, or None when the plan compiler
        refuses it (the per-shard interpreter runs it then).  Distinct
        operands are computed first and enter as Precomputed rows.  The
        span plan.compile."""
        with TRACER.span("plan.compile"):
            self._precompute_distinct(index, call)
            try:
                return PlanCompiler(index).compile(call)
            except PlanError:
                return None

    def _precompute_distinct(self, index: Index, call: Call) -> None:
        """Replace each Distinct of a bitmap tree, in place, by its result
        over every shard as a Precomputed row: a BSI field's non-negative
        values as columns (reference handlePreCalls executor.go:364), for
        the planner and for the interpreter."""
        if call.name == "Distinct":
            result = self._execute_distinct(index, call, None)
            if isinstance(result, SignedRow):
                result = result.pos
            call.name, call.args, call.children = \
                "Precomputed", {"_row": result}, []
            return
        for ch in call.children:
            self._precompute_distinct(index, ch)

    def _execute_union_rows(self, index: Index, call: Call,
                            shards: Optional[List[int]]) -> Row:
        """UnionRows(Rows(f)...): the union of every enumerated row's bitmap
        (reference executeUnionRows)."""
        acc = Row()
        for ch in call.children:
            if ch.name != "Rows":
                raise ExecError("UnionRows() children must be Rows() calls")
            fname = ch.args.get("_field") or ch.args.get("field")
            for rid in self._execute_rows(index, ch, shards):
                acc = acc.union(self._execute_bitmap_call(
                    index, Call("Row", {fname: rid}), shards))
        return acc

    def _execute_limit(self, index: Index, call: Call,
                       shards: Optional[List[int]]) -> Row:
        """Limit(bitmap, limit=, offset=) (reference executeLimitCall)."""
        if not call.children:
            raise ExecError("Limit() requires a child call")
        limit = call.args.get("limit")
        offset = int(call.args.get("offset", 0))
        row = self._execute_bitmap_call(index, call.children[0], shards)
        cols = row.columns()
        if offset:
            cols = cols[offset:]
        if limit is not None:
            cols = cols[: int(limit)]
        return Row.from_columns(cols)

    # ----------------------------------------------------- bitmap calls

    def _execute_bitmap_call(self, index: Index, call: Call,
                             shards: Optional[List[int]]) -> Row:
        if call.name == "All" and ("limit" in call.args
                                   or "offset" in call.args):
            # All(limit=, offset=): a global column cut (reference
            # executeAllCallShard executor.go:5781)
            return self._execute_limit(
                index, Call("Limit", {"limit": call.args.get("limit"),
                                      "offset": call.args.get("offset", 0)},
                            children=[Call("All")]), shards)
        shard_list = self._shards(index, shards)
        plan = self._try_compile(index, call)
        if plan is not None and shard_list:
            stacked = self.plan_executor.run_bitmap(index, plan, shard_list)
            if self.mesh is not None:
                segs = stacked.rows(self.device)
                return Row({s: segs[s] for s in shard_list})
            return Row({s: stacked[i] for i, s in enumerate(shard_list)})
        return Row({s: self._bitmap_call_shard(index, call, s)
                    for s in shard_list})

    def _mesh_filter(self, index: Index, filt_call: Optional[Call],
                     shards: List[int]) -> Optional[torch.Tensor]:
        """Stacked (S, W) filter words (the JAX package's mesh-aggregate
        filter; on a mesh Sharded (S_pad, W), padding rows zero): all ones
        with no filter, else the plan-compiled filter in word mode; None
        when the filter is not plannable (the caller goes per shard)."""
        pe = self.plan_executor
        if filt_call is None:
            return pe.stacked_full(index, shards)
        plan = self._try_compile(index, filt_call)
        if plan is None:
            return None
        return pe.run_bitmap(index, plan, shards)

    # ------------------------------------------ the per-shard interpreter

    def _zero(self) -> torch.Tensor:
        return torch.zeros(WORDS_PER_ROW, dtype=torch.int32,
                           device=self.device)

    def _bitmap_call_shard(self, index: Index, call: Call, shard: int
                           ) -> torch.Tensor:
        """Evaluate a bitmap-producing call for one shard -> (W,) int32
        words on the executor's device (reference executeBitmapCallShard
        executor.go:1782).  Set algebra is torch ops on the shard's rows
        from the fragment mirrors; BSI rows run kernel A at S = 1."""
        name = call.name
        if name in ("Row", "Range"):
            return self._row_shard(index, call, shard)
        if name == "Union":
            out = self._zero()
            for ch in call.children:
                out = out | self._bitmap_call_shard(index, ch, shard)
            return out
        if name == "Intersect":
            if not call.children:
                raise ExecError("Intersect() requires at least one child")
            out = self._bitmap_call_shard(index, call.children[0], shard)
            for ch in call.children[1:]:
                out = out & self._bitmap_call_shard(index, ch, shard)
            return out
        if name == "Difference":
            if not call.children:
                return self._zero()
            out = self._bitmap_call_shard(index, call.children[0], shard)
            for ch in call.children[1:]:
                out = bw.b_andnot(out,
                                  self._bitmap_call_shard(index, ch, shard))
            return out
        if name == "Xor":
            out = self._zero()
            for ch in call.children:
                out = out ^ self._bitmap_call_shard(index, ch, shard)
            return out
        if name == "Not":
            # complement within the index existence row (reference
            # executeNotShard executor.go:5554)
            ex = self._existence_shard(index, shard)
            return bw.b_andnot(ex, self._bitmap_call_shard(
                index, call.children[0], shard))
        if name == "All":
            return self._existence_shard(index, shard)
        if name == "Shift":
            child = self._bitmap_call_shard(index, call.children[0], shard)
            return bw.b_shift(child, int(call.args.get("n", 1)))
        if name == "ConstRow":
            cols = call.args.get("columns", [])
            in_shard = [c % SHARD_WIDTH for c in cols
                        if isinstance(c, int) and c // SHARD_WIDTH == shard]
            words = bw.cols_to_words(np.array(in_shard, dtype=np.int64))
            return torch.from_numpy(words.view(np.int32)).to(self.device)
        if name == "Precomputed":
            seg = call.args["_row"].segment(shard)
            return seg.to(self.device) if seg is not None else self._zero()
        if name in ("Distinct", "UnionRows", "Limit"):
            # pre-calls: computed globally once and embedded (reference
            # handlePreCalls executor.go:364)
            if name == "Distinct":
                self._precompute_distinct(index, call)
            else:
                result = self._execute_call(index, call, None)
                call.name, call.args, call.children = \
                    "Precomputed", {"_row": result}, []
            return self._bitmap_call_shard(index, call, shard)
        if name == "Rows":
            # Rows in bitmap position: the columns with any value of the
            # field (in the time views of from=/to=)
            return self._rows_bitmap_shard(index, call, shard)
        raise ExecError(f"unknown bitmap call: {name}")

    def _rows_bitmap_shard(self, index: Index, call: Call, shard: int
                           ) -> torch.Tensor:
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        from_t, to_t = call.args.get("from"), call.args.get("to")
        if from_t is not None or to_t is not None:
            from datetime import datetime

            from featurebase_tpu_torch.model.timequantum import parse_time
            lo = parse_time(from_t) if from_t is not None \
                else datetime(1, 1, 1)
            hi = parse_time(to_t) if to_t is not None \
                else datetime(9999, 1, 1)
            names = f.views_for_range(lo, hi)
        else:
            names = [VIEW_STANDARD]
        out = self._zero()
        for vn in names:
            v = f.view(vn)
            frag = v.fragment(shard) if v is not None else None
            if frag is None or frag.num_rows == 0:
                continue
            out = out | bw.or_reduce_rows(frag.device_tile(self.device))
        return out

    def _existence_shard(self, index: Index, shard: int) -> torch.Tensor:
        ef = index.existence_field()
        if ef is None:
            raise ExecError("index does not track existence")
        v = ef.view(VIEW_STANDARD)
        frag = v.fragment(shard) if v else None
        if frag is None:
            return self._zero()
        return frag.device_row(0, self.device)

    def _row_shard(self, index: Index, call: Call, shard: int
                   ) -> torch.Tensor:
        fld, val = call.field_arg()
        if fld is None:
            raise ExecError("Row() requires a field argument")
        f = self._field_or_err(index, fld)
        if isinstance(val, Condition):
            return self._row_bsi_shard(index, f, val, shard)
        if f.is_bsi():
            # Row(f=5) on an int field is the equality predicate
            return self._row_bsi_shard(index, f, Condition("==", val), shard)
        if val is None:
            # Row(f=null): records with no bit in this field
            ex = self._existence_shard(index, shard)
            v = f.view(VIEW_STANDARD)
            frag = v.fragment(shard) if v else None
            if frag is None or frag.num_rows == 0:
                return ex
            return bw.b_andnot(
                ex, bw.or_reduce_rows(frag.device_tile(self.device)))
        row_id = int(val)
        if row_id == -1:
            return self._zero()
        acc = self._zero()
        for vn in _time_views(f, call):
            v = f.view(vn)
            frag = v.fragment(shard) if v else None
            if frag is not None:
                acc = acc | frag.device_row(row_id, self.device)
        return acc

    def _row_bsi_shard(self, index: Index, f: Field, cond: Condition,
                       shard: int) -> torch.Tensor:
        """BSI predicate row (reference executeRowBSIGroupShard
        executor.go:5249; fragment.rangeOp:937): the comparators of
        ops/bsi.py on the shard's group, kernel A at S = 1."""
        data = f.bsi_data(shard, self.device)
        if data is None:
            return self._zero()
        group, depth = data
        op, v = cond.op, cond.value
        if op == "!=" and v is None:
            return group[0]
        if op == "==" and v is None:
            return bw.b_andnot(self._existence_shard(index, shard), group[0])

        def enc(x) -> int:
            return f.encode_value(x) - f.base
        if op == "betw":
            lo, hi = v
            return bsiops.range_between(
                group, enc(lo) + (1 if cond.lo_strict else 0),
                enc(hi) - (1 if cond.hi_strict else 0), depth)
        pred = enc(v)
        if op == "==":
            return bsiops.range_eq(group, pred, depth)
        if op == "!=":
            return bsiops.range_neq(group, pred, depth)
        if op in ("<", "<="):
            return bsiops.range_lt(group, pred, depth, op == "<=")
        if op in (">", ">="):
            return bsiops.range_gt(group, pred, depth, op == ">=")
        raise ExecError(f"unsupported condition op: {op}")

    # ------------------------------------------------------------- Count

    def _execute_count(self, index: Index, call: Call,
                       shards: Optional[List[int]]) -> int:
        """Count(bitmap) (reference executeCount executor.go:5839): the plan
        and its popcount fused in kernel A, or the interpreter's words of
        every shard counted by one kernel-A launch."""
        if not call.children:
            raise ExecError("Count() requires a child call")
        child = call.children[0]
        if child.name == "Distinct":
            res = self._execute_distinct(index, child, shards)
            if isinstance(res, SignedRow):
                return int(res.values().size)
            return res.count()
        shard_list = self._shards(index, shards)
        if not shard_list:
            return 0
        plan = self._try_compile(index, child)
        if plan is not None:
            return self.plan_executor.run_count(index, plan, shard_list)
        words = [self._bitmap_call_shard(index, child, s) for s in shard_list]
        return int(to_host(bw.popcount(torch.stack(words))))

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
        view_names = _time_views(f, call)
        if self.mesh is not None:
            res = self._topn_mesh(index, f, fld, n, filt_call, view_names,
                                  self._shards(index, shards))
            if res is not None:
                return res

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
        with TRACER.span("agg.finish"):
            pairs = [Pair(id=rid, count=c) for rid, c in counts.items()]
            pairs.sort(key=lambda p: (-p.count, p.id))
            if n:
                pairs = pairs[: int(n)]
            return PairsField(pairs, fld)

    def _topn_mesh(self, index: Index, f: Field, fld: str, n, filt_call,
                   view_names: List[str], shard_list: List[int]
                   ) -> Optional[PairsField]:
        """Mesh TopN (JAX executor.py:1639): every candidate row counted
        against the filter over every shard, kernel B' on each member's
        block and one merge (replaces the coordinator's Pairs.Add merge,
        executor.go:2831), with no rank cache.  None when the filter does
        not plan."""
        if not shard_list:
            return PairsField([], fld)
        filt = self._mesh_filter(index, filt_call, shard_list)
        if filt is None:
            return None
        row_ids = sorted({int(r) for vn in view_names for s in shard_list
                          if (vv := f.view(vn)) is not None
                          and (fr := vv.fragment(s)) is not None
                          for r in fr.row_ids()}
                         | f.meta_rows(view_names))
        if not row_ids:
            return PairsField([], fld)
        tiles = self.plan_executor.stacked_field_rows(
            index, fld, tuple(view_names), tuple(row_ids), shard_list)
        pc = to_host(agg.row_counts(self.mesh, tiles, filt))
        with TRACER.span("agg.finish"):
            pairs = [Pair(id=r, count=int(c))
                     for r, c in zip(row_ids, pc) if c]
            pairs.sort(key=lambda p: (-p.count, p.id))
            if n:
                pairs = pairs[: int(n)]
            return PairsField(pairs, fld)

    def _topn_count_shards(self, index: Index, f: Field, names, filt_call,
                           missing: List[int], miss_gens: Dict[int, tuple],
                           use_cache: bool, counts: Dict[int, int]):
        """Per-row counts for cache-missing shards with kernel B: one
        stacked (S, R, W) launch over all of them, or a launch per shard
        when the stacked tile would exceed ROWS_STACKED_MAX_BYTES or the
        filter is not plannable (the interpreter gives each shard's filter
        then).  Complete per-shard count sets refresh the rank cache."""
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
                          for r in fr.row_ids()} | f.meta_rows(names))
        if not row_ids:
            return
        pe = self.plan_executor
        tile_bytes = len(row_ids) * len(missing) * WORDS_PER_ROW * 4
        filt = None
        stacked = tile_bytes <= self.ROWS_STACKED_MAX_BYTES
        if stacked and filt_call is not None:
            filt = self._mesh_filter(index, filt_call, missing)
            stacked = filt is not None
        if stacked:
            tiles = pe.stacked_field_rows(index, f.name, names,
                                          tuple(row_ids), missing)
            pc = to_host(bw.per_shard_row_counts(tiles) if filt is None
                         else bw.per_shard_filtered_row_counts(tiles, filt))
            for si, shard in enumerate(missing):
                add_shard(shard, row_ids, pc[si])
            return
        # per shard: kernel B over every shard of each residency batch in one
        # launch, each reading its fragment's mirror in place (a fresh tile
        # of the union where the call spans several views), under the
        # interpreter's words of each shard
        dev = self.device
        parts = []
        for batch in self._residency_batches(
                missing, [f.view(vn) for vn in names]):
            live, tiles, slots, fws = [], [], [], []
            for shard in batch:
                frs = frags_of(shard)
                srows = sorted({int(r) for fr in frs for r in fr.row_ids()})
                if not srows:
                    continue
                if len(frs) == 1:
                    tile, sl = frs[0].device_slots(row_ids, dev)
                else:
                    tile = pe.stacked_field_rows(index, f.name, names,
                                                 tuple(srows), [shard])[0]
                    at = {r: i for i, r in enumerate(srows)}
                    sl = np.array([at.get(r, -1) for r in row_ids],
                                  dtype=np.int64)
                live.append(shard)
                tiles.append(tile)
                slots.append(sl)
                if filt_call is not None:
                    fws.append(self._bitmap_call_shard(index, filt_call,
                                                       shard))
            if live:
                parts.append((live, ck.row_counts_sharded(
                    tiles, np.stack(slots),
                    fws if filt_call is not None else None)))
        for (live, _), pc in zip(parts, _fetch([p for _, p in parts])):
            for si, shard in enumerate(live):
                add_shard(shard, row_ids, pc[si])

    # ----------------------------------------------------- Sum / Min / Max

    def _agg_inputs(self, index: Index, call: Call):
        fld = call.args.get("_field") or call.args.get("field")
        if fld is None:
            raise ExecError(f"{call.name}() requires a field")
        f = self._field_or_err(index, fld)
        filt_call = call.children[0] if call.children else None
        return f, filt_call

    def _shard_group_batches(self, index: Index, f: Field,
                             filt_call: Optional[Call], shards,
                             out_rows: int = 0):
        """Per-shard inputs of a BSI call whose filter the plan compiler
        refuses, a residency batch at a time (_residency_batches, with
        `out_rows` rows of output a shard): (shards, groups, filter rows) of
        the batch's shards with BSI data, each group its fragment's device
        mirror and the slots of the planes exists, sign and each magnitude
        bit (-1 absent) there, each filter row the interpreter's words of
        the shard, or None without a filter (reference: the map_shards
        fallbacks, executor.py:1182); the sharded kernels read a None row
        as zeros, so Sum and Min/Max hand them _all_ones(fws)."""
        v = f.view(view_bsi_group(f.name))
        if v is None:
            return
        rows = [BSI_EXISTS_ROW, BSI_SIGN_ROW] + \
            [BSI_OFFSET + i for i in range(max(f.bit_depth, 1))]
        for batch in self._residency_batches(shards, [v], out_rows):
            live, groups, fws = [], [], []
            for shard in batch:
                frag = v.fragment(shard)
                if frag is None or frag.num_rows == 0:
                    continue
                live.append(shard)
                groups.append(frag.device_slots(rows, self.device))
                fws.append(None if filt_call is None else
                           self._bitmap_call_shard(index, filt_call, shard))
            if groups:
                yield live, groups, fws

    def _all_ones(self, fws):
        """Filter rows for the sharded C' and D' launches: all ones where
        a shard has no filter call (JAX executor.py:1143 _shard_filter;
        the launches read a None row as zeros)."""
        if any(fw is not None for fw in fws):
            return fws
        return [self._shard_filter(None, None, 0)] * len(fws)

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
        kernel-C' launch over the stacked group, or under a filter the plan
        compiler refuses one over every shard's mirror per residency batch
        (bsi_sum_planes_sharded); finished exactly on the host."""
        f, filt_call = self._agg_inputs(index, call)
        shard_list = self._shards(index, shards)
        if not shard_list:
            return self._wrap_valcount(f, 0, 0)
        filt = self._mesh_filter(index, filt_call, shard_list)
        if filt is not None:
            group = self.plan_executor.stacked_bsi(
                index, f.name, max(f.bit_depth, 1), shard_list)
            if self.mesh is not None:
                pp, nn, cnt = agg.sum_planes(self.mesh, group, filt)
                parts = to_host(torch.cat([pp, nn, cnt.reshape(1)]))
            else:
                parts = to_host(ck.bsi_sum_planes(group, filt))
        else:
            per_batch = [ck.bsi_sum_planes_sharded(g, self._all_ones(fws))
                         for _, g, fws in self._shard_group_batches(
                             index, f, filt_call, shard_list)]
            if not per_batch:
                return self._wrap_valcount(f, 0, 0)
            parts = to_host(torch.stack(per_batch).sum(0))
        with TRACER.span("agg.finish"):
            D = (parts.size - 1) // 2
            count = int(parts[2 * D])
            total = finalize_sum(parts[:D], parts[D:2 * D]) + f.base * count
            return self._wrap_valcount(f, total, count)

    def _execute_min_max(self, index: Index, call: Call,
                         shards: Optional[List[int]], is_min: bool
                         ) -> ValCount:
        """Min/Max (JAX executor.py:1199): one kernel-D' launch over the
        stacked group, or under a filter the plan compiler refuses one over
        every shard's mirror per residency batch (bsi_min_max_sharded),
        each running the two descents a Min or a Max needs.  Up to depth 31
        under a plannable filter the answer has min_max_stacked's
        semantics; deeper, or under a filter the plan compiler refuses, the
        reference's per-shard min_host/max_host merged with
        ValCount.smaller/larger (ops/bsi.py)."""
        f, filt_call = self._agg_inputs(index, call)
        shard_list = self._shards(index, shards)
        if not shard_list:
            return self._wrap_valcount(f, 0, 0)
        filt = self._mesh_filter(index, filt_call, shard_list)
        if filt is not None:
            group = self.plan_executor.stacked_bsi(
                index, f.name, max(f.bit_depth, 1), shard_list)
            parts = to_host(agg.min_max_parts(self.mesh, group, filt, is_min)
                            if self.mesh is not None else
                            ck.bsi_min_max(group, filt, is_min))
            if max(f.bit_depth, 1) <= 31:
                with TRACER.span("agg.finish"):
                    v, c = bsiops.min_max_stacked_finish(parts, is_min)
                    if c == 0:
                        return self._wrap_valcount(f, 0, 0)
                    return self._wrap_valcount(f, v + f.base, c)
        else:
            per_batch = [ck.bsi_min_max_sharded(g, self._all_ones(fws),
                                                is_min)
                         for _, g, fws in self._shard_group_batches(
                             index, f, filt_call, shard_list)]
            if not per_batch:
                return self._wrap_valcount(f, 0, 0)
            parts = to_host(torch.cat(per_batch))
        with TRACER.span("agg.finish"):
            acc = ValCount()
            for v, c in bsiops.min_max_per_shard(parts, is_min):
                if c == 0:
                    continue
                vc = ValCount(v + f.base, c)
                acc = acc.smaller(vc) if is_min else acc.larger(vc)
            return self._wrap_valcount(f, acc.val, acc.count)

    # --------------------------------------------------- Var / Corr (SQL)

    def _host_filter_bits(self, index: Index, filt, shard: int):
        """A shard's filter as (SHARD_WIDTH,) bools from the interpreter's
        words, or None without a filter call."""
        if not isinstance(filt, Call):
            return None
        words = self._bitmap_call_shard(index, filt, shard)
        return decode.expand_bits_host(host_words(words))

    def _var_moments(self, index: Index, f: Field, filt,
                     shards: Optional[List[int]]):
        """(n, Sum x, Sum x^2) of the true values (JAX executor.py:1380):
        exact Python ints from one kernel-H launch over the stacked group
        when the filter is plannable and the depth at most 31, else float64
        sums on the host (the reference accumulates in float64,
        expressionagg.go:1130)."""
        shard_list = self._shards(index, shards)
        depth = max(f.bit_depth, 1)
        if shard_list and depth <= bsiops.MAX_MOMENTS_DEPTH:
            filt_words = self._mesh_filter(
                index, filt if isinstance(filt, Call) else None, shard_list)
            if filt_words is not None:
                bsi = self.plan_executor.stacked_bsi(index, f.name, depth,
                                                     shard_list)
                if self.mesh is not None:
                    out = agg.moments(self.mesh, _members(
                        ck.var_moments, bsi, filt_words))
                else:
                    out = list(ck.var_moments(bsi, filt_words))
                cnt, p, n_, sq = _fetch(out)
                return bsiops.finalize_var_moments(cnt, p, n_, sq, f.base)
        n, tot, tot_sq = 0, 0, 0.0
        for shard in shard_list:
            dense = f.values_dense_host(shard)
            if dense is None:
                continue
            vals_d, mask = dense
            fbits = self._host_filter_bits(index, filt, shard)
            if fbits is not None:
                mask = mask & fbits
            v = vals_d[mask].astype(np.float64) + f.base
            n += int(mask.sum())
            tot += float(v.sum())
            tot_sq += float((v * v).sum())
        return n, tot, tot_sq

    def _execute_var(self, index: Index, call: Call,
                     shards: Optional[List[int]]):
        """Var(field=v[, filter=...]): population variance to 6 decimal
        places, or None without values (JAX executor.py:1424; reference
        sql3 VAR aggregate, expressionagg.go:1110)."""
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        if not f.is_bsi():
            raise ExecError("Var() requires an int-like field")
        moments = self._var_moments(index, f, call.args.get("filter"),
                                    shards)
        if call.args.get("_moments"):
            return {"moments": list(moments)}
        return self.var_of(f, *moments)

    @staticmethod
    def var_of(f: Field, n, tot, tot_sq):
        """Var's answer from its moments (a node's, or a cluster's summed
        over its nodes: cluster/distributed.py)."""
        if n == 0:
            return None
        scale = 10.0 ** f.options.scale
        mean = tot / n / scale
        var = tot_sq / n / (scale * scale) - mean * mean
        return round(max(var, 0.0), 6)

    def _execute_corr(self, index: Index, call: Call,
                      shards: Optional[List[int]]):
        """Corr(field=a, field2=b[, filter=...]): the Pearson correlation
        over the records where both values exist, to 6 decimal places, or
        None without them or with a zero variance (JAX executor.py:1444;
        reference sql3 CORR aggregate, expressionagg.go:950-1045).  With
        _moments (a cluster node's leg) the moments (n, Sum x, Sum y,
        Sum xy, Sum x^2, Sum y^2) instead."""
        fx, fy = self.corr_fields(index, call)
        moments = self._corr_moments(index, fx, fy, call.args.get("filter"),
                                     shards)
        if call.args.get("_moments"):
            return {"moments": list(moments)}
        return self.corr_of(fx, fy, *moments)

    def corr_fields(self, index: Index, call: Call):
        fx_name = call.args.get("_field") or call.args.get("field")
        fy_name = call.args.get("field2") or call.args.get("other")
        if not fx_name or not fy_name:
            raise ExecError("Corr() requires field= and field2=")
        fx = self._field_or_err(index, fx_name)
        fy = self._field_or_err(index, fy_name)
        if not fx.is_bsi() or not fy.is_bsi():
            raise ExecError("Corr() requires int-like fields")
        return fx, fy

    def _corr_moments(self, index: Index, fx: Field, fy: Field, filt,
                      shards: Optional[List[int]]) -> tuple:
        """(n, Sum x, Sum y, Sum xy, Sum x^2, Sum y^2) of the records where
        both values exist: exact ints from one kernel-H' launch when the
        filter is plannable and both depths at most 31, else float64 sums
        on the host."""
        shard_list = self._shards(index, shards)
        dx, dy = max(fx.bit_depth, 1), max(fy.bit_depth, 1)
        n = tx = ty = txy = txx = tyy = 0
        done = False
        if shard_list and max(dx, dy) <= bsiops.MAX_MOMENTS_DEPTH:
            filt_words = self._mesh_filter(
                index, filt if isinstance(filt, Call) else None, shard_list)
            if filt_words is not None:
                pe = self.plan_executor
                bx = pe.stacked_bsi(index, fx.name, dx, shard_list)
                by = pe.stacked_bsi(index, fy.name, dy, shard_list)
                if self.mesh is not None:
                    out = agg.moments(self.mesh, _members(
                        ck.corr_moments, bx, by, filt_words))
                else:
                    out = list(ck.corr_moments(bx, by, filt_words))
                (cnt, xp, xn, yp, yn, sqx, sqy, pp, pm, mp, mm) = _fetch(out)
                n = int(cnt)
                _, _, txx = bsiops.finalize_var_moments(cnt, xp, xn, sqx,
                                                        fx.base)
                _, _, tyy = bsiops.finalize_var_moments(cnt, yp, yn, sqy,
                                                        fy.base)
                tx, ty, txy = bsiops.finalize_cross_moments(
                    xp, xn, yp, yn, (pp, pm, mp, mm), fx.base, fy.base, n)
                done = True
        if not done:
            for shard in shard_list:
                d1 = fx.values_dense_host(shard)
                d2 = fy.values_dense_host(shard)
                if d1 is None or d2 is None:
                    continue
                v1, e1 = d1
                v2, e2 = d2
                mask = e1 & e2
                fbits = self._host_filter_bits(index, filt, shard)
                if fbits is not None:
                    mask = mask & fbits
                a = v1[mask].astype(np.float64) + fx.base
                b = v2[mask].astype(np.float64) + fy.base
                n += int(mask.sum())
                tx += float(a.sum())
                ty += float(b.sum())
                txy += float((a * b).sum())
                txx += float((a * a).sum())
                tyy += float((b * b).sum())
        return n, tx, ty, txy, txx, tyy

    @staticmethod
    def corr_of(fx: Field, fy: Field, n, tx, ty, txy, txx, tyy):
        """Corr's answer from its moments (a node's, or a cluster's summed
        over its nodes)."""
        if n == 0:
            return None
        sx = 10.0 ** fx.options.scale
        sy = 10.0 ** fy.options.scale
        num = (n * txy - tx * ty) / (sx * sy)
        den2 = (n * txx - tx * tx) / (sx * sx) \
            * ((n * tyy - ty * ty) / (sy * sy))
        if den2 <= 0:
            return None   # zero variance: the reference divides to NaN
        return round(num / math.sqrt(den2), 6)

    # -------------------------------------------------------------- writes

    def _execute_set(self, index: Index, call: Call) -> bool:
        """Set(col, f=row[, timestamp]) (reference executor.go executeSet;
        JAX executor.py:765)."""
        col = call.args.get("_col")
        if col is None or col == -1:
            raise ExecError("Set() requires a column")
        fld, val = call.field_arg()
        if fld is None:
            raise ExecError("Set() requires a field=value argument")
        f = self._field_or_err(index, fld)
        if f.is_bsi():
            try:
                changed = f.set_value(int(col), val)
            except ValueError as e:   # out of range: a user error
                raise ExecError(str(e))
        else:
            changed = f.set_bit(int(val), int(col),
                                timestamp=call.args.get("_timestamp"))
        index.mark_exists(np.array([int(col)]))
        return changed

    def _execute_clear(self, index: Index, call: Call) -> bool:
        """Clear(col, f=row) (reference executor.go executeClearBit)."""
        col = call.args.get("_col")
        fld, val = call.field_arg()
        f = self._field_or_err(index, fld)
        if col is None or col == -1:
            return False
        if f.is_bsi():
            return f.clear_value(int(col))
        return f.clear_bit(int(val), int(col))

    def _execute_clear_row(self, index: Index, call: Call,
                           shards: Optional[List[int]]) -> bool:
        """ClearRow(f=row) (reference executor.go executeClearRow): True
        when some shard's row had a bit, read from the host master."""
        fld, val = call.field_arg()
        f = self._field_or_err(index, fld)
        row = int(val)
        v = f.view(VIEW_STANDARD)
        changed = False
        for shard in self._shards(index, shards):
            frag = v.fragment(shard) if v else None
            if frag is not None and frag.has_row(row):
                changed |= bool(frag.host_row(row).any())
                frag.clear_row(row)
        return changed

    def _execute_store(self, index: Index, call: Call,
                       shards: Optional[List[int]]) -> bool:
        """Store(bitmap, f=row) (reference executor.go executeSetRow): the
        child's words a shard, one device-to-host copy each, replace the
        row."""
        fld, val = call.field_arg()
        f = self._field_or_err(index, fld)
        row = int(val)
        for shard in self._shards(index, shards):
            words = self._bitmap_call_shard(index, call.children[0], shard)
            frag = f.standard_view().create_fragment_if_not_exists(shard)
            frag.write_row_words(row, host_words(words))
        return True

    def _execute_delete(self, index: Index, call: Call,
                        shards: Optional[List[int]]) -> bool:
        """Delete(filter): clear the matching records from every fragment
        of the index, and on a keyed index their keys (reference
        executor.go:9050 executeDeleteRecords)."""
        if not call.children:
            raise ExecError("Delete() requires a filter")
        changed = False
        for shard in self._shards(index, shards):
            words = host_words(
                self._bitmap_call_shard(index, call.children[0], shard))
            if not words.any():
                continue
            changed = True
            for f in index.fields.values():
                for v in f.views.values():
                    frag = v.fragment(shard)
                    if frag is not None:
                        frag.clear_columns(words)
            if index.options.keys:
                cols = bw.words_to_cols(words, base=shard * SHARD_WIDTH)
                for part in index.translate_store.partitions.values():
                    for c in cols:
                        k = part.id_to_key.pop(int(c), None)
                        if k is not None:
                            part.key_to_id.pop(k, None)
        return changed

    def _execute_min_max_row(self, index: Index, call: Call,
                             shards: Optional[List[int]], is_min: bool
                             ) -> PairField:
        """MinRow/MaxRow (reference executor.go:1604,1643; JAX
        executor.py:1238): the row counts of every shard's device mirror of
        the field, unfiltered, with one kernel-B launch per residency batch
        (_residency_batches) and one fetch; per shard the smallest
        (largest) row with a set bit.  Ties across shards add counts."""
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        v = f.view(VIEW_STANDARD)
        shard_rows, launches = [], []
        batches = self._residency_batches(self._shards(index, shards), [v]) \
            if v is not None else []
        for batch in batches:
            tiles = []
            for shard in batch:
                frag = v.fragment(shard)
                if frag is None or frag.num_rows == 0:
                    continue
                tile = frag.device_tile(self.device)
                tiles.append(tile)
                shard_rows.append(frag.slot_rows()[: tile.shape[0]])
            if tiles:
                n = [t.shape[0] for t in tiles]
                slots = np.where(np.arange(max(n))[None, :]
                                 < np.array(n)[:, None],
                                 np.arange(max(n))[None, :], -1)
                launches.append(ck.row_counts_sharded(tiles, slots))
        counts = [row for c in _fetch(launches) for row in c]
        best_row, best_count = None, 0
        for slot_rows, cnt in zip(shard_rows, counts):
            rows = np.array(slot_rows, dtype=np.int64)
            cnt = cnt[: rows.size]
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

    # ------------------------------------------------------------- Rows

    def _execute_rows(self, index: Index, call: Call,
                      shards: Optional[List[int]],
                      verify_nonempty: bool = True) -> List[int]:
        """Rows(f, ...) row-id enumeration through the row-scan framework
        (reference executeRows executor.go:4077; ops/rowscan.py).  Without
        a column filter the candidates come from host metadata and one
        kernel-B launch over the stacked candidate tile drops the empty
        ones; with column=, or above ROWS_STACKED_MAX_BYTES, each shard
        scans its fragments.  verify_nonempty=False (GroupBy's dimensions,
        which drop empty groups themselves) skips the device work."""
        from featurebase_tpu_torch.ops.rowscan import (RowScanSpec, host_prune,
                                                       scan_fragments)
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        limit = call.args.get("limit")
        prev = call.args.get("previous")
        col = call.args.get("column")
        like = call.args.get("like")
        in_list = call.args.get("in")

        like_ids = None
        if like is not None and f.options.keys:
            # LIKE pushdown: one translate-store pass (reference like.go:13)
            like_ids = set(index.row_translation(fld).match_like(like))
        whitelist = {int(x) for x in in_list} if in_list is not None else None
        names = _time_views(f, call)

        def spec() -> RowScanSpec:
            return RowScanSpec(
                whitelist=whitelist, like_ids=like_ids,
                min_row_excl=int(prev) if prev is not None else None)

        shard_list = self._shards(index, shards)
        if col is None and shard_list:
            cand = sorted({int(r) for s in shard_list for vn in names
                           if (vv := f.view(vn)) is not None
                           and (fr := vv.fragment(s)) is not None
                           for r in fr.row_ids()} | f.meta_rows(names))
            cand = host_prune(cand, spec())
            if not cand:
                return []
            if not verify_nonempty and limit is None:
                return cand
            tile_bytes = len(cand) * len(shard_list) * WORDS_PER_ROW * 4
            if tile_bytes <= self.ROWS_STACKED_MAX_BYTES:
                tiles = self.plan_executor.stacked_field_rows(
                    index, fld, tuple(names), tuple(cand), shard_list)
                counts = to_host(agg.row_counts(self.mesh, tiles, None)
                                 if self.mesh is not None else
                                 bw.stacked_row_counts(tiles))
                rows_sorted = [r for r, c in zip(cand, counts) if c]
                if limit is not None:
                    rows_sorted = rows_sorted[: int(limit)]
                return rows_sorted

        out: set = set()
        for shard in shard_list:
            sp = spec()
            if col is not None:
                c = int(col)
                if c // SHARD_WIDTH != shard:
                    continue
                sp.column = c % SHARD_WIDTH
            frags = [(vv := f.view(vn)) and vv.fragment(shard)
                     for vn in names]
            out.update(scan_fragments(frags, sp, self.device))
        rows_sorted = sorted(out)
        if limit is not None:
            rows_sorted = rows_sorted[: int(limit)]
        return rows_sorted

    # ----------------------------------------------------------- GroupBy

    def _execute_group_by(self, index: Index, call: Call,
                          shards: Optional[List[int]]) -> List[GroupCount]:
        """GroupBy(Rows(f1), Rows(f2), ..., limit=, filter=, aggregate=,
        having=) (reference executor.go:3176 executeGroupBy, 8617
        groupByIterator): the stacked one-shot over every shard when it
        fits the caps; else, where each shard would take the one-shot
        product, one launch over every shard's mirrors; else a loop over
        the shards (level-wise pruning) whose counts and sums stay on the
        device until one fetch after it."""
        rows_calls = [c for c in call.children if c.name == "Rows"]
        if not rows_calls:
            raise ExecError("GroupBy() requires at least one Rows() child")
        limit = call.args.get("limit")
        filt_call = call.args.get("filter")
        agg_call = call.args.get("aggregate")
        having = call.args.get("having")

        agg_field: Optional[Field] = None
        agg_kind = None
        if isinstance(agg_call, Call):
            agg_kind = agg_call.name  # Sum or Count
            if agg_kind == "Sum":
                afld = agg_call.args.get("_field") or \
                    agg_call.args.get("field")
                agg_field = self._field_or_err(index, afld)

        fields = [c.args.get("_field") or c.args.get("field")
                  for c in rows_calls]
        # candidate rows per dimension with every Rows argument applied
        # globally (reference precomputes nested Rows, executor.go:3987)
        dim_rows_global = [self._execute_rows(index, rc, shards,
                                              verify_nonempty=False)
                           for rc in rows_calls]
        groups: Dict[tuple, List[int]] = {}  # key -> [count, agg]
        shard_list = self._shards(index, shards)
        if not ((self.mesh is not None
                 and self._group_by_mesh(index, shard_list, rows_calls,
                                         dim_rows_global, filt_call,
                                         agg_kind, agg_field, groups))
                or self._group_by_stacked(index, shard_list, rows_calls,
                                       dim_rows_global, filt_call, agg_kind,
                                       agg_field, groups)
                or self._group_by_launch(index, shard_list, rows_calls,
                                         dim_rows_global, filt_call,
                                         agg_kind, agg_field, groups)):
            pending: list = []
            level0 = self._group_level0(index, shard_list, rows_calls,
                                        dim_rows_global, filt_call)
            for shard, (counts0, fw) in level0.items():
                self._group_by_shard_device(index, shard, rows_calls,
                                            dim_rows_global, counts0, fw,
                                            agg_kind, agg_field, pending)
            self._add_pending(pending, groups)

        # assemble, sort by group key, apply having + limit
        out = []
        with TRACER.span("agg.finish"):
            for key, (cnt, agg) in sorted(groups.items()):
                if cnt == 0:
                    continue
                group = [FieldRow(field=fields[i], row_id=key[i])
                         for i in range(len(fields))]
                gc = GroupCount(group, count=cnt, agg=agg)
                if agg_field is not None and \
                        agg_field.options.type == TYPE_DECIMAL:
                    gc.decimal_agg = agg / (10 ** agg_field.options.scale)
                out.append(gc)
        if agg_kind == "Count" and agg_call.children and \
                agg_call.children[0].name == "Distinct":
            # aggregate=Count(Distinct(field=x)): for each group,
            # Count(Distinct(Intersect(group rows, filter), field=x))
            # (reference executor.go:3342)
            dist = agg_call.children[0]
            for gc in out:
                kids = [Call("Row", {fr.field: fr.row_id})
                        for fr in gc.group]
                if isinstance(filt_call, Call):
                    kids.append(filt_call)
                if dist.children:
                    kids.append(dist.children[0])
                inner = Call("Distinct", dict(dist.args),
                             children=[Call("Intersect", children=kids)])
                gc.agg = self._execute_count(
                    index, Call("Count", children=[inner]), shards)
        if isinstance(having, Call):
            out = self._apply_having(out, having, agg_field)
        if limit is not None:
            out = out[: int(limit)]
        return out

    @staticmethod
    def _add_counts(groups, keys, counts) -> None:
        with TRACER.span("agg.finish"):
            for key, c in zip(keys, counts):
                if c:
                    g = groups.setdefault(key, [0, 0])
                    g[0] += int(c)

    @staticmethod
    def _add_sums(groups, keys, parts: np.ndarray) -> None:
        """Each group's (sum, count) from kernel F's counters; the count is
        the group's columns with a value (reference sum_groups_host)."""
        with TRACER.span("agg.finish"):
            for key, (s, c) in zip(keys, bsiops.finish_groups(parts)):
                if c == 0:
                    continue
                g = groups.setdefault(key, [0, 0])
                g[0] += c
                g[1] += s

    def _add_pending(self, pending: list, groups) -> None:
        """Fold the per-shard loop's results into `groups`: device counts
        and sums of every shard in one fetch."""
        dev = [(i, x) for i, (_, _, x) in enumerate(pending)
               if isinstance(x, torch.Tensor)]
        host = dict(zip((i for i, _ in dev), _fetch([x for _, x in dev])))
        for i, (keys, kind, x) in enumerate(pending):
            x = host.get(i, x)
            if kind == "sum":
                self._add_sums(groups, keys, x)
            else:
                self._add_counts(groups, keys, x.reshape(-1))

    def _group_by_stacked(self, index: Index, shard_list, rows_calls,
                          dim_rows_global, filt_call, agg_kind, agg_field,
                          groups) -> bool:
        """Every shard's cross-product in one launch with one fetch (JAX
        executor.py:2007).  Returns False to go per shard (over the caps,
        or a filter the plan compiler refuses)."""
        if not shard_list or any(not grows for grows in dim_rows_global):
            return True
        n_combos = 1
        for rows in dim_rows_global:
            n_combos *= len(rows)
        n_levels = len(rows_calls)
        w_bytes = WORDS_PER_ROW * 4 * len(shard_list)
        if agg_kind != "Sum":
            prefix = (n_combos // len(dim_rows_global[-1])
                      if n_levels > 1 else 1)
            if (n_combos > self.GROUPBY_ONESHOT_MAX_COUNTS
                    or prefix * w_bytes >
                    self.GROUPBY_ONESHOT_MAX_MASK_BYTES):
                return False
        elif agg_field is None or n_combos * w_bytes > \
                self.GROUPBY_ONESHOT_MAX_MASK_BYTES:
            return False
        filt = None
        if isinstance(filt_call, Call):
            filt = self._mesh_filter(index, filt_call, shard_list)
            if filt is None:
                return False
        pe = self.plan_executor
        dim_tiles = []
        dim_rows: List[List[int]] = []
        for rc, grows in zip(rows_calls, dim_rows_global):
            fname = rc.args.get("_field") or rc.args.get("field")
            dim_tiles.append(pe.stacked_field_rows(
                index, fname, (VIEW_STANDARD,), tuple(grows), shard_list))
            dim_rows.append([int(r) for r in grows])
        keys = itertools.product(*dim_rows)

        if agg_kind != "Sum":
            if n_levels == 1:
                counts = (bw.stacked_row_counts(dim_tiles[0]) if filt is None
                          else bw.stacked_filtered_row_counts(dim_tiles[0],
                                                              filt))
            elif n_levels == 2:   # kernel E with the filter fused
                counts = bw.stacked_pair_counts(dim_tiles[0], dim_tiles[1],
                                                filt)
            else:
                masks = dim_tiles[0] if filt is None else \
                    bw.stacked_mask_filter(dim_tiles[0], filt)
                for lvl in range(1, n_levels - 1):
                    masks = bw.stacked_all_pairs_and(masks, dim_tiles[lvl])
                counts = bw.stacked_pair_counts(masks, dim_tiles[-1])
            self._add_counts(groups, keys, to_host(counts.reshape(-1)))
            return True
        masks = dim_tiles[0] if filt is None else \
            bw.stacked_mask_filter(dim_tiles[0], filt)
        for lvl in range(1, n_levels):
            masks = bw.stacked_all_pairs_and(masks, dim_tiles[lvl])
        bsi = pe.stacked_bsi(index, agg_field.name,
                             max(agg_field.bit_depth, 1), shard_list)
        self._add_sums(groups, keys,
                       to_host(ck.bsi_sum_groups(bsi, masks.contiguous())))
        return True

    def _group_by_mesh(self, index: Index, shard_list: List[int],
                       rows_calls, dim_rows_global, filt_call, agg_kind,
                       agg_field, groups) -> bool:
        """Mesh GroupBy (JAX executor.py:1846): the one-shot product over
        every shard when it fits the caps, else the level-wise frontier
        expansion with each level's counts one kernel-E' launch a member
        and one merge (replaces per-shard goroutines + mergeGroupCounts,
        executor.go:8617,3728).  Returns False to go per shard (a filter
        the plan compiler refuses)."""
        if not shard_list:
            return True
        filt = self._mesh_filter(
            index, filt_call if isinstance(filt_call, Call) else None,
            shard_list)
        if filt is None:
            return False
        if any(not grows for grows in dim_rows_global):
            return True   # a dimension without rows: no groups
        mesh, pe = self.mesh, self.plan_executor
        dim_tiles = []
        dim_rows: List[List[int]] = []
        for rc, grows in zip(rows_calls, dim_rows_global):
            fname = rc.args.get("_field") or rc.args.get("field")
            dim_tiles.append(pe.stacked_field_rows(
                index, fname, (VIEW_STANDARD,), tuple(grows), shard_list))
            dim_rows.append([int(r) for r in grows])
        if self._group_by_mesh_one_shot(dim_rows, dim_tiles, filt, agg_kind,
                                        agg_field, index, shard_list, groups):
            return True
        counts = to_host(agg.row_counts(mesh, dim_tiles[0], filt))
        keep = np.nonzero(counts)[0]
        if keep.size == 0:
            return True
        prefixes: List[tuple] = [(dim_rows[0][i],) for i in keep]
        counts = counts[keep]
        masks = None
        if len(dim_tiles) > 1 or agg_kind == "Sum":
            masks = agg.take_rows(mesh, agg.mask_filter(mesh, dim_tiles[0],
                                                        filt), keep)
        for lvl in range(1, len(dim_tiles)):
            pc = to_host(agg.pair_counts(mesh, masks, dim_tiles[lvl]))
            fi, rj = np.nonzero(pc)
            if fi.size == 0:
                return True
            counts = pc[fi, rj]
            prefixes = [prefixes[i] + (dim_rows[lvl][j],)
                        for i, j in zip(fi, rj)]
            masks = agg.gather_and(mesh, masks, dim_tiles[lvl], fi, rj)
        if agg_kind == "Sum" and agg_field is not None:
            self._add_sums(groups, prefixes, self._mesh_group_sums(
                index, masks, agg_field, shard_list))
        else:
            self._add_counts(groups, prefixes, counts)
        return True

    def _mesh_group_sums(self, index: Index, masks, agg_field: Field,
                         shard_list: List[int]) -> np.ndarray:
        """(G, 2D + 1) kernel-F' counters of each mask over the mesh (the
        form _add_sums takes)."""
        bsi = self.plan_executor.stacked_bsi(
            index, agg_field.name, max(agg_field.bit_depth, 1), shard_list)
        pp, nn, cnt = agg.group_sums(self.mesh, masks, bsi)
        return to_host(torch.cat([pp, nn, cnt[:, None]], 1))

    def _group_by_mesh_one_shot(self, dim_rows, dim_tiles, filt, agg_kind,
                                agg_field, index: Index, shard_list,
                                groups) -> bool:
        """Every combination materialized shard-locally by static index
        vectors and its counts or sums merged once (JAX executor.py:2085);
        False when over the caps."""
        mesh = self.mesh
        n_combos = int(np.prod([len(rows) for rows in dim_rows]))
        n_levels = len(dim_tiles)
        w_bytes = WORDS_PER_ROW * 4   # a combination mask a shard

        def expand_static(masks, lvl):
            F, R = masks.blocks[0].shape[1], dim_tiles[lvl].blocks[0].shape[1]
            return agg.gather_and(mesh, masks, dim_tiles[lvl],
                                  np.repeat(np.arange(F), R),
                                  np.tile(np.arange(R), F))
        keys = itertools.product(*dim_rows)
        if agg_kind != "Sum":
            prefix = n_combos // len(dim_rows[-1]) if n_levels > 1 else 1
            if (n_combos > self.GROUPBY_ONESHOT_MAX_COUNTS
                    or prefix * w_bytes >
                    self.GROUPBY_ONESHOT_MAX_MASK_BYTES):
                return False
            if n_levels == 1:
                counts = agg.row_counts(mesh, dim_tiles[0], filt)
            else:
                masks = agg.mask_filter(mesh, dim_tiles[0], filt)
                for lvl in range(1, n_levels - 1):
                    masks = expand_static(masks, lvl)
                counts = agg.pair_counts(mesh, masks, dim_tiles[-1])
            self._add_counts(groups, keys, to_host(counts.reshape(-1)))
            return True
        if agg_field is None or \
                n_combos * w_bytes > self.GROUPBY_ONESHOT_MAX_MASK_BYTES:
            return False
        masks = agg.mask_filter(mesh, dim_tiles[0], filt)
        for lvl in range(1, n_levels):
            masks = expand_static(masks, lvl)
        self._add_sums(groups, keys, self._mesh_group_sums(
            index, masks, agg_field, shard_list))
        return True

    def _group_by_launch(self, index: Index, shard_list, rows_calls,
                         dim_rows_global, filt_call, agg_kind, agg_field,
                         groups) -> bool:
        """Every shard's cross product in one launch of kernel E or F that
        reads each shard's rows where they live, in its fragments' device
        mirrors (pair_counts_sharded, bsi_sum_groups_sharded), one launch a
        residency batch, with one fetch after the last.  Taken where every
        shard of the JAX package's per-shard loop takes its one-shot product
        (JAX executor.py:2160), judged on the global rows: counts of two or
        three dimensions within GROUPBY_ONESHOT_MAX_COUNTS combinations;
        sums of one to three within the one-shot's groups (a mask of each
        within GROUPBY_ONESHOT_MAX_MASK_BYTES, though none is stored).
        Returns False to go per shard (level-wise pruning)."""
        n_levels = len(rows_calls)
        n_combos = int(np.prod([len(r) for r in dim_rows_global]))
        if agg_kind == "Sum":
            if agg_field is None or n_levels > 3 or n_combos * \
                    WORDS_PER_ROW * 4 > self.GROUPBY_ONESHOT_MAX_MASK_BYTES:
                return False
        elif not 2 <= n_levels <= 3 or \
                n_combos > self.GROUPBY_ONESHOT_MAX_COUNTS:
            return False
        views = [self._field_or_err(
            index, rc.args.get("_field") or rc.args.get("field")).view(
                VIEW_STANDARD) for rc in rows_calls]
        sources = list(views)
        if agg_kind == "Sum":
            sources.append(agg_field.view(view_bsi_group(agg_field.name)))
        total = None
        for batch in self._residency_batches(shard_list, sources):
            part = self._group_launch_batch(index, batch, views,
                                            dim_rows_global, filt_call,
                                            agg_kind, agg_field)
            if part is not None:
                total = part if total is None else total + part
        if total is not None:
            keys = itertools.product(*[[int(r) for r in rows]
                                       for rows in dim_rows_global])
            if agg_kind == "Sum":
                self._add_sums(groups, keys, to_host(total))
            else:
                self._add_counts(groups, keys, to_host(total.reshape(-1)))
        return True

    @staticmethod
    def _residency_batches(shard_list, views,
                           out_rows: int = 0) -> List[List[int]]:
        """Shards in runs whose mirrors of `views` (and a filter row and
        `out_rows` rows of a launch's output each) fit the residency budget
        together, so that one launch can read them all at once; a shard
        larger than the budget runs alone."""
        from featurebase_tpu_torch.storage.residency import residency
        budget = residency().budget
        batches: List[List[int]] = []
        cur, cur_bytes = [], 0
        for s in shard_list:
            rows = 1 + out_rows + sum(
                fr.num_rows for v in views if v is not None
                and (fr := v.fragment(s)) is not None)
            nbytes = rows * WORDS_PER_ROW * 4
            if cur and cur_bytes + nbytes > budget:
                batches.append(cur)
                cur, cur_bytes = [], 0
            cur.append(s)
            cur_bytes += nbytes
        if cur:
            batches.append(cur)
        return batches

    def _group_launch_batch(self, index: Index, batch: List[int], views,
                            dim_rows_global, filt_call, agg_kind, agg_field
                            ) -> Optional[torch.Tensor]:
        """One launch of _group_by_launch over the shards of `batch` that
        can hold a group (a fragment of every dimension, and BSI data for a
        Sum): each dimension's (tiles, slots) from one device_slots() call a
        fragment; the filter as _mesh_filter's words, or the interpreter's
        words of each shard when the plan compiler refuses it.  None when
        no shard can."""
        dev = self.device
        live, dims, bsi = [], [[] for _ in views], []
        for s in batch:
            frags = [v.fragment(s) if v is not None else None for v in views]
            if any(fr is None or fr.num_rows == 0 for fr in frags):
                continue
            data = agg_field.bsi_data(s, dev) if agg_kind == "Sum" else None
            if agg_kind == "Sum" and data is None:
                continue
            live.append(s)
            bsi.append(data)
            for d, fr, grows in zip(dims, frags, dim_rows_global):
                d.append(fr.device_slots(grows, dev))
        if not live:
            return None
        dims = [([t for t, _ in d], np.stack([sl for _, sl in d]))
                for d in dims]
        filt = None
        if isinstance(filt_call, Call):
            filt = self._mesh_filter(index, filt_call, live)
            if filt is None:
                filt = [self._bitmap_call_shard(index, filt_call, s)
                        for s in live]
        if agg_kind == "Sum":
            return ck.bsi_sum_groups_sharded([d[0] for d in bsi], dims, filt)
        (mt, ms), *mid, (rt, rs) = dims
        return ck.pair_counts_sharded(mt, ms, rt, rs, filt,
                                      mid[0] if mid else None)

    def _group_level0(self, index: Index, shard_list: List[int], rows_calls,
                      dim_rows_global, filt_call) -> Dict[int, tuple]:
        """Level 0 of the per-shard GroupBy for every shard at once: the
        first dimension's rows [& the filter] of each shard that holds a row
        of every dimension, counted by one kernel-B launch per residency
        batch over the fragments' mirrors and fetched once.  The filter is
        _mesh_filter's words, or each shard's interpreter words when the
        plan compiler refuses it.  Returns {shard: (counts over
        dim_rows_global[0], the shard's filter words or None)} for the
        shards with a nonzero count, in shard order."""
        dev = self.device
        views = [self._field_or_err(
            index, rc.args.get("_field") or rc.args.get("field")).view(
                VIEW_STANDARD) for rc in rows_calls]
        live = [s for s in shard_list if all(
            v is not None and (fr := v.fragment(s)) is not None
            and any(fr.has_row(r) for r in grows)
            for v, grows in zip(views, dim_rows_global))]
        parts = []
        for batch in self._residency_batches(live, views[:1]):
            tiles, slots = [], []
            for s in batch:
                tile, sl = views[0].fragment(s).device_slots(
                    dim_rows_global[0], dev)
                tiles.append(tile)
                slots.append(sl)
            fws = None
            if isinstance(filt_call, Call):
                filt = self._mesh_filter(index, filt_call, batch)
                fws = list(filt) if filt is not None else [
                    self._bitmap_call_shard(index, filt_call, s)
                    for s in batch]
            parts.append((batch, fws, ck.row_counts_sharded(
                tiles, np.stack(slots), fws)))
        out: Dict[int, tuple] = {}
        for (batch, fws, _), counts in zip(
                parts, _fetch([c for _, _, c in parts])):
            for i, s in enumerate(batch):
                if counts[i].any():
                    out[s] = (counts[i], None if fws is None else fws[i])
        return out

    def _group_by_shard_device(self, index: Index, shard: int, rows_calls,
                               dim_rows_global, counts0: np.ndarray, fw,
                               agg_kind, agg_field, pending: list) -> None:
        """One shard's cross product by level-wise pruning (JAX
        executor.py:1923; reference groupByIterator executor.go:8617,8651),
        from its level-0 counts (_group_level0; fw its filter words or
        None): each later level's (F, R) counts (kernel E) are fetched to
        keep the nonzero combinations, and one gather builds their masks.
        Small cross products never come here: _group_by_stacked or
        _group_by_launch take them over every shard at once.  Appends
        (keys, kind, counts or sums) to `pending`; sums stay on the
        device."""
        dev = self.device
        dim_tiles = []
        dim_rows: List[List[int]] = []
        for rc, grows in zip(rows_calls, dim_rows_global):
            fname = rc.args.get("_field") or rc.args.get("field")
            frag = self._field_or_err(index, fname).view(
                VIEW_STANDARD).fragment(shard)
            if not dim_tiles:   # level 0: the rows with a nonzero count
                rows = [grows[i] for i in np.nonzero(counts0)[0]]
            else:
                rows = [r for r in grows if frag.has_row(r)]
            dim_tiles.append(frag.device_rows(rows, dev)[0])
            dim_rows.append(rows)
        masks = dim_tiles[0]
        if fw is not None:
            masks = masks & fw[None, :]
        prefixes: List[tuple] = [(r,) for r in dim_rows[0]]
        counts = counts0[counts0 != 0]
        for lvl in range(1, len(dim_tiles)):
            tile = dim_tiles[lvl]
            pc = to_host(bw.count_and_pairs(masks, tile))  # (F, R)
            fi, rj = np.nonzero(pc)
            if fi.size == 0:
                return
            counts = pc[fi, rj]
            prefixes = [prefixes[i] + (dim_rows[lvl][j],)
                        for i, j in zip(fi, rj)]
            masks = bw.and_pairs_gather(masks, tile,
                                        torch.as_tensor(fi, device=dev),
                                        torch.as_tensor(rj, device=dev))
        if agg_kind == "Sum" and agg_field is not None:
            data = agg_field.bsi_data(shard, dev)
            if data is None:
                return
            pending.append((prefixes, "sum", ck.bsi_sum_groups(
                data[0][None], masks[None].contiguous())))
        else:
            pending.append((prefixes, "count", counts))

    def _apply_having(self, groups: List[GroupCount], having: Call,
                      agg_field=None) -> List[GroupCount]:
        """Having(count > x) / Having(sum < y) (reference
        satisfiesCondition executor.go:3787).  Decimal aggregates hold
        scaled ints (gc.agg = value * 10^scale), so literals in the
        condition are scaled to the same fixed point before comparing:
        exact, no float round trips."""
        out = []
        for k, cond in having.args.items():
            if not isinstance(cond, Condition):
                cond = Condition("==", cond)
            if (k != "count" and agg_field is not None
                    and agg_field.options.type == TYPE_DECIMAL):
                s = 10 ** agg_field.options.scale

                def scaled(v, s=s):
                    return int(round(v * s))
                if cond.op == "betw":
                    lo, hi = cond.value
                    c2 = Condition("betw", (scaled(lo), scaled(hi)))
                    c2.lo_strict = cond.lo_strict
                    c2.hi_strict = cond.hi_strict
                    cond = c2
                else:
                    cond = Condition(cond.op, scaled(cond.value))
            for gc in groups:
                v = gc.count if k == "count" else gc.agg
                if self._cond_matches(cond, v):
                    out.append(gc)
            return out
        return groups

    @staticmethod
    def _cond_matches(cond: Condition, v) -> bool:
        op, cv = cond.op, cond.value
        if op == "==":
            return v == cv
        if op == "!=":
            return v != cv
        if op == "<":
            return v < cv
        if op == "<=":
            return v <= cv
        if op == ">":
            return v > cv
        if op == ">=":
            return v >= cv
        if op == "betw":
            lo, hi = cv
            if cond.lo_strict:
                lo = lo + 1
            if cond.hi_strict:
                hi = hi - 1
            return lo <= v <= hi
        return False

    # ------------------------------------------------------------ Distinct

    def _gather_host(self, parts: List[np.ndarray]) -> List[np.ndarray]:
        """Host arrays of every process of a mesh that spans processes, in
        process order; `parts` itself otherwise."""
        if self.mesh is None or self.mesh.group is None:
            return parts
        from featurebase_tpu_torch.parallel.multihost import \
            all_gather_object
        return [a for p in all_gather_object(self.mesh, parts) for a in p]

    def _shard_filter(self, index: Index, filt_call: Optional[Call],
                      shard: int) -> torch.Tensor:
        """One shard's (W,) filter words: all ones without a filter."""
        if filt_call is None:
            return torch.full((WORDS_PER_ROW,), -1, dtype=torch.int32,
                              device=self.device)
        return self._bitmap_call_shard(index, filt_call, shard)

    def _present_words(self, groups, fws) -> torch.Tensor:
        """(n, W) words of the columns that hold a value under the filter:
        each (tile, slots) group's exists row (zeros where the fragment
        lacks it) & its filter row (None: no filter)."""
        ex = torch.stack([tile[int(sl[0])] if sl[0] >= 0 else self._zero()
                          for tile, sl in groups])
        if all(fw is None for fw in fws):
            return ex
        ones = torch.full((WORDS_PER_ROW,), -1, dtype=torch.int32,
                          device=self.device)
        return ex & torch.stack([ones if fw is None else fw for fw in fws])

    def _execute_distinct(self, index: Index, call: Call,
                          shards: Optional[List[int]]):
        """Distinct(filter?, field=f) (reference executeDistinct
        executor.go:1173; JAX executor.py:2313).  A set field gives the
        rows with a column under the filter, counted by kernel B over the
        stacked rows (one launch a shard past ROWS_STACKED_MAX_BYTES or
        under a filter the plan compiler refuses), as a Row.  A BSI field
        gives its distinct values as a SignedRow: up to depth 31,
        torch.unique over the present columns of the cached stacked decode
        (kernel G'') under the stacked filter, or under a filter the plan
        compiler refuses of one decode over every shard's mirror a residency
        batch (bsi_decode_sharded) under each shard's interpreted filter;
        deeper, each shard's host decode."""
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        filt_call = call.children[0] if call.children else None
        shard_list = self._shards(index, shards)
        if not f.is_bsi():
            return self._distinct_rows(index, f, filt_call, shard_list)
        depth = max(f.bit_depth, 1)
        filt = None
        if shard_list and depth <= decode.DEVICE_MAX_DEPTH:
            filt = self._mesh_filter(index, filt_call, shard_list)
        parts: List[np.ndarray] = []
        if filt is not None:
            pe = self.plan_executor
            bsi = pe.stacked_bsi(index, f.name, depth, shard_list)
            vals = pe.stacked_vals(index, f.name, depth, shard_list)

            def uniq(g, v, fw):
                return torch.unique(v[decode.expand_bits(g[:, 0] & fw).bool()])
            if self.mesh is None:
                parts = _fetch([uniq(bsi, vals, filt)])
            else:   # a union of the members' values
                parts = self._gather_host(_fetch(_members(uniq, bsi, vals,
                                                          filt)))
        elif depth <= decode.DEVICE_MAX_DEPTH:
            dev_parts = []
            for _, groups, fws in self._shard_group_batches(
                    index, f, filt_call, shard_list, DECODE_ROWS):
                vals = ck.bsi_decode_sharded(groups)
                present = decode.expand_bits(
                    self._present_words(groups, fws)).bool()
                dev_parts.append(torch.unique(vals[present]))
            parts = _fetch(dev_parts)
        else:
            for shard in shard_list:
                dense = f.values_dense_host(shard)
                if dense is None:
                    continue
                vals, exists_b = dense
                fw = self._shard_filter(index, filt_call, shard)
                present = exists_b & decode.expand_bits_host(host_words(fw))
                parts.append(np.unique(vals[present]))
        uniq = np.unique(np.concatenate(parts)) if parts else \
            np.zeros(0, dtype=np.int64)
        uniq = uniq.astype(np.int64) + f.base
        return SignedRow(Row.from_columns(np.sort(-uniq[uniq < 0])),
                         Row.from_columns(uniq[uniq >= 0]), field=fld)

    def _distinct_rows(self, index: Index, f: Field,
                       filt_call: Optional[Call], shard_list: List[int]
                       ) -> Row:
        """Distinct over a set field: the row ids with a column under the
        filter."""
        v = f.view(VIEW_STANDARD)
        if shard_list:
            row_ids = sorted({int(r) for s in shard_list
                              if v is not None
                              and (fr := v.fragment(s)) is not None
                              for r in fr.row_ids()}
                             | f.meta_rows((VIEW_STANDARD,)))
            if not row_ids:
                return Row.from_columns([])
            tile_bytes = len(row_ids) * len(shard_list) * WORDS_PER_ROW * 4
            filt = self._mesh_filter(index, filt_call, shard_list) \
                if tile_bytes <= self.ROWS_STACKED_MAX_BYTES \
                or self.mesh is not None else None
            if filt is not None:
                tiles = self.plan_executor.stacked_field_rows(
                    index, f.name, (VIEW_STANDARD,), tuple(row_ids),
                    shard_list)
                pc = agg.row_counts(self.mesh, tiles, filt) \
                    if self.mesh is not None else \
                    bw.stacked_filtered_row_counts(tiles, filt)
                return Row.from_columns(
                    [r for r, c in zip(row_ids, pc.cpu().numpy()) if c])
        # per shard: kernel B over every shard of each residency batch in one
        # launch, the mirrors read in place, under the interpreter's words
        # of each shard
        row_ids = sorted({int(r) for s in shard_list if v is not None
                          and (fr := v.fragment(s)) is not None
                          for r in fr.row_ids()})
        parts = []
        for batch in self._residency_batches(shard_list, [v]) if row_ids \
                else []:
            frags = [v.fragment(s) for s in batch]
            live = [s for s, fr in zip(batch, frags)
                    if fr is not None and fr.num_rows]
            if not live:
                continue
            tiles, slots = zip(*(v.fragment(s).device_slots(
                row_ids, self.device) for s in live))
            fws = None if filt_call is None else [
                self._bitmap_call_shard(index, filt_call, s) for s in live]
            parts.append(ck.row_counts_sharded(list(tiles), np.stack(slots),
                                               fws))
        seen = np.zeros(len(row_ids), dtype=bool)
        for pc in _fetch(parts):
            seen |= (pc > 0).any(0)
        return Row.from_columns([r for r, hit in zip(row_ids, seen) if hit])

    # ------------------------------------------ IncludesColumn / FieldValue

    def _execute_includes_column(self, index: Index, call: Call) -> bool:
        """IncludesColumn(bitmap, column=c): the bit of c in its shard's
        words (JAX executor.py:2398)."""
        col = call.args.get("column")
        if col is None:
            raise ExecError("IncludesColumn() requires a column argument")
        if not call.children:
            raise ExecError("IncludesColumn() requires a row query")
        col = int(col)
        words = host_words(self._bitmap_call_shard(index, call.children[0],
                                                   col // SHARD_WIDTH))
        c = col % SHARD_WIDTH
        return bool((words[c >> 5] >> (c & 31)) & 1)

    def _execute_field_value(self, index: Index, call: Call) -> ValCount:
        """FieldValue(field=f, column=c): one column's value from the host
        master bits (JAX executor.py:2414)."""
        fld = call.args.get("_field") or call.args.get("field")
        col = call.args.get("column")
        if fld is None or col is None:
            raise ExecError("FieldValue() requires field and column")
        f = self._field_or_err(index, fld)
        if isinstance(col, str):
            col = index.translate_store.find_keys([col]).get(col, -1)
        if col == -1:
            return ValCount()
        val, ok = f.value(int(col))
        if not ok:
            return ValCount()
        return self._wrap_valcount(f, val, 1)

    # ---------------------------------------------------------- Percentile

    def _percentile_device(self, index: Index, f: Field, filt,
                           shard_list: List[int]):
        """(values, exists, filter words, counts) of Percentile's device
        route, kernel I' over the cached stacked decode: up to depth 31 on
        an int, decimal or timestamp field whose based values fit int32,
        under a filter the plan compiler takes; else None."""
        depth = max(f.bit_depth, 1)
        if not (shard_list and depth <= decode.DEVICE_MAX_DEPTH
                and f.options.type in (TYPE_INT, TYPE_DECIMAL,
                                       TYPE_TIMESTAMP)
                and abs(f.base) + (1 << depth) < 2**31 - 2):
            return None
        filt_words = self._mesh_filter(
            index, filt if isinstance(filt, Call) else None, shard_list)
        if filt_words is None:
            return None
        pe = self.plan_executor
        bsi = pe.stacked_bsi(index, f.name, depth, shard_list)
        vals = pe.stacked_vals(index, f.name, depth, shard_list)
        if self.mesh is None:
            return vals, bsi[:, 0], filt_words, None
        # each round: kernel I' a member, the bins added
        return (vals, bsi.map(lambda g: g[:, 0]), filt_words,
                functools.partial(agg.percentile_counts, self.mesh))

    def _execute_percentile(self, index: Index, call: Call,
                            shards: Optional[List[int]]
                            ) -> Optional[ValCount]:
        """Percentile(field=f, nth=, filter=) (reference executor.go:1310;
        JAX executor.py:1273): up to depth 31 on an int, decimal or
        timestamp field whose based values fit int32, under a filter the
        plan compiler takes, the bisection of ops/decode.py over kernel I's
        counts of the cached stacked decode; else the reference's host
        bisection over Counts (kernel A) and Min/Max (kernel D).  Both test
        the exact rational thresholds."""
        nth = call.args.get("nth")
        if nth is None:
            raise ExecError("Percentile(): nth required")
        nth = float(nth)
        if nth < 0 or nth > 100:
            raise ExecError("Percentile(): nth must be in [0, 100]")
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        filt = call.args.get("filter")
        filt_children = [filt] if isinstance(filt, Call) else []
        shard_list = self._shards(index, shards)
        device = self._percentile_device(index, f, filt, shard_list)
        if "_thresholds" in call.args:
            # a cluster node's leg: kernel I's bins of these thresholds over
            # its shards (None without the device route), which the
            # coordinator adds up for decode.percentile
            ts = call.args["_thresholds"]
            if not shard_list:
                return {"pctCounts": [0] * (2 * len(ts) + 1)
                        + [(1 << 31) - 1, -(1 << 31)]}
            if device is None:
                return {"pctCounts": None}
            vals, exists, filt_words, counts = device
            return {"pctCounts": (counts or ck.percentile_counts)(
                vals, exists, filt_words, int(f.base), ts).cpu().tolist()}
        if device is not None:
            vals, exists, filt_words, counts = device
            val, cnt = decode.percentile(vals, exists, filt_words,
                                         int(f.base), nth, counts)
            if cnt == 0:
                return None
            return self._wrap_valcount(f, val, cnt)

        def count_of(cond: Optional[Condition]) -> int:
            row_call = Call("Row", {fld: cond if cond is not None
                                    else Condition("!=", None)})
            inner = row_call
            if filt_children:
                inner = Call("Intersect", children=[row_call] + filt_children)
            return self._execute_count(index, Call("Count", children=[inner]),
                                       shards)

        total = count_of(None)
        if total == 0:
            return None
        num, den = decode.nth_ratio(nth)
        desired_less = total * num // den
        desired_greater = total * (den - num) // den
        minc = Call("Min", {"_field": fld}, children=filt_children[:])
        maxc = Call("Max", {"_field": fld}, children=filt_children[:])
        if desired_greater != 0:
            min_vc = self._execute_min_max(index, minc, shards, is_min=True)
            if desired_less == 0:
                return min_vc
        max_vc = self._execute_min_max(index, maxc, shards, is_min=False)
        if desired_greater == 0:
            return max_vc
        lo, hi = min_vc.val, max_vc.val
        possible = lo
        while lo < hi:
            possible = decode.pivot(lo, hi)
            # bisection in stored units: a decimal's predicate is decoded
            # first, since Row() encodes its value
            raw = f.decode_value(possible) \
                if f.options.type == TYPE_DECIMAL else possible
            left = count_of(Condition("<", raw))
            if left > desired_less:
                hi = possible - 1
                continue
            right = count_of(Condition(">", raw))
            if right > desired_greater:
                lo = possible + 1
                continue
            break
        return self._wrap_valcount(f, possible, 1)

    # ---------------------------------------------------------------- Sort

    def _execute_sort(self, index: Index, call: Call,
                      shards: Optional[List[int]]) -> dict:
        """Sort(filter, field=f, limit=, offset=, sort-desc=, after=[value,
        column]) -> {"columns", "values"} in (value, column) order
        (reference executeSort executor.go:9321; JAX executor.py:2569).
        Up to depth 31 the values come from the cached stacked decode
        (kernel G'') under a filter the plan compiler takes, else from one
        decode over every shard's mirror a residency batch
        (bsi_decode_sharded) under each shard's interpreted filter; with a
        limit (and a stacked filter), every shard's top offset + limit at
        once (_sort_top), the cursor's mask ANDed into the filter; without
        one, a sort a shard.  Past depth 31, each shard's host decode and
        sort on the worker pool.  Then one fetch and one merge.  `after`
        keeps only records strictly after the cursor."""
        fld = call.args.get("_field") or call.args.get("field")
        f = self._field_or_err(index, fld)
        if not f.is_bsi():
            raise ExecError("Sort() requires an int-like field")
        desc = bool(call.args.get("sort-desc", call.args.get("desc", False)))
        limit = call.args.get("limit")
        offset = int(call.args.get("offset", 0))
        after = call.args.get("after")
        after_raw = after_col = None
        if after is not None:
            after_raw, after_col = int(after[0]) - f.base, int(after[1])
        filt_call = call.children[0] if call.children else None
        take = None if limit is None else offset + int(limit)
        shard_list = self._shards(index, shards)
        depth = max(f.bit_depth, 1)
        filt = None
        if shard_list and depth <= decode.DEVICE_MAX_DEPTH \
                and take is not None:
            filt = self._mesh_filter(index, filt_call, shard_list)
        cut = None if take is None else min(take, SHARD_WIDTH)
        cursor = None if after is None else (after_raw, after_col)
        tops, runs = [], []   # (shards, device top-k); (shard, sorted run)
        if filt is not None:
            pe = self.plan_executor
            vals = pe.stacked_vals(index, fld, depth, shard_list)
            bsi = pe.stacked_bsi(index, fld, depth, shard_list)
            if self.mesh is None:
                tops.append((shard_list, self._sort_top(
                    vals, bsi[:, 0] & filt, shard_list, cut, desc, cursor)))
            else:   # each member's top of its block, merged below
                for k, (v, g, fw) in enumerate(zip(
                        vals.blocks, bsi.blocks, filt.blocks)):
                    lay = vals.shards_of(k)
                    tops.append((lay, self._sort_top(
                        v, g[:, 0] & fw, lay, cut, desc, cursor)))
        elif depth <= decode.DEVICE_MAX_DEPTH:
            for live, groups, fws in self._shard_group_batches(
                    index, f, filt_call, shard_list, SORT_ROWS):
                vals = ck.bsi_decode_sharded(groups)
                present = self._present_words(groups, fws)
                if cut is not None:
                    tops.append((live, self._sort_top(vals, present, live,
                                                      cut, desc, cursor)))
                    continue
                present = decode.expand_bits(present).bool()
                runs += [(shard, decode.sort_shard(vals[i], present[i], desc))
                         for i, shard in enumerate(live)]
        else:   # the host decodes and sorts on the pool, the filter here
            dense = dict(zip(shard_list,
                             map_shards(f.values_dense_host, shard_list)))
            live = [s for s in shard_list if dense[s] is not None]
            fws = dict(zip(live, self._host_shard_words(
                index, filt_call, live))) if filt_call is not None else {}

            def host_run(shard):
                vals_d, exists_b = dense[shard]
                if shard in fws:
                    exists_b = exists_b & decode.expand_bits_host(fws[shard])
                cols = np.nonzero(exists_b)[0].astype(np.int64)
                v = vals_d[cols]
                order = np.lexsort((cols, -v if desc else v))
                return shard, (cols[order], v[order])
            runs += map_shards(host_run, live)
        dev = [x for _, top in tops for x in top] + \
            [x for _, run in runs for x in run if isinstance(x, torch.Tensor)]
        host = iter(_fetch(dev))
        cols_parts, vals_parts = [], []
        for shards_of, _ in tops:
            idx, keys, n_present = next(host), next(host), next(host)
            for si, shard in enumerate(shards_of):
                n = min(int(n_present[si]), cut)
                if n:
                    cols_parts.append(idx[si, :n] + shard * SHARD_WIDTH)
                    vals_parts.append(-keys[si, :n] if desc
                                      else keys[si, :n])
        for shard, (cols, v) in runs:
            if isinstance(cols, torch.Tensor):
                cols, v = next(host), next(host)
            if after is not None:
                later = (v < after_raw) if desc else (v > after_raw)
                keep = later | ((v == after_raw)
                                & (cols + shard * SHARD_WIDTH > after_col))
                cols, v = cols[keep], v[keep]
            if take is not None:
                cols, v = cols[:take], v[:take]
            if cols.size:
                cols_parts.append(cols + shard * SHARD_WIDTH)
                vals_parts.append(v)
        if self.mesh is not None and filt is not None:
            cols_parts = self._gather_host(cols_parts)
            vals_parts = self._gather_host(vals_parts)
        return self._sort_merge(f, cols_parts, vals_parts, desc, offset,
                                limit)

    def _sort_top(self, vals: torch.Tensor, present: torch.Tensor, shards,
                  cut: int, desc: bool, cursor) -> tuple:
        """Device (columns, keys, present counts) of each shard's first
        `cut` columns in (value, column) order (decode.sort_stacked) over
        (S, C) decoded values and (S, W) words of the columns to sort, the
        keyset cursor's mask ANDed in when `cursor` = (unbased value,
        column) is given."""
        filt = None
        if cursor is not None:
            col0 = torch.tensor(shards, dtype=torch.int64,
                                device=vals.device) * SHARD_WIDTH
            av = int(np.clip(cursor[0], -(2**31), 2**31 - 1))
            filt = decode.after_mask_stacked(vals, col0, av, cursor[1], desc)
        return decode.sort_stacked(vals, present, desc, cut, filt)

    @staticmethod
    def _sort_merge(f: Field, cols_parts, vals_parts, desc: bool,
                    offset: int, limit) -> dict:
        """Merge of the per-shard sorted runs (reference k-way merge,
        executor.go:9574)."""
        if not cols_parts:
            return {"columns": [], "values": []}
        cols_all = np.concatenate(cols_parts)
        vals_all = np.concatenate(vals_parts)
        order = np.lexsort((cols_all, -vals_all if desc else vals_all))
        if offset:
            order = order[offset:]
        if limit is not None:
            order = order[: int(limit)]
        return {"columns": [int(c) for c in cols_all[order]],
                "values": [f.decode_value(int(v) + f.base)
                           for v in vals_all[order]]}

    # ------------------------------------------------------------- Extract

    _EXTRACT_FILTERS = ("Row", "Union", "Intersect", "Difference", "Xor",
                        "Not", "All", "ConstRow", "Limit", "Distinct",
                        "Precomputed", "Rows", "UnionRows", "Range", "Shift")

    def _execute_extract(self, index: Index, call: Call,
                         shards: Optional[List[int]]) -> ExtractedTable:
        """Extract(filter, Rows(f)...) (reference executeExtract
        executor.go:4711, executeExtractShard:4758; JAX executor.py:2431):
        each matched record's value of each field, columnar, in column
        order.  The filter's words come from the host existence rows for
        All(), else from one stacked plan (kernel A) fetched once, else
        from the interpreter a shard.  With every shard's matched columns
        in hand, each BSI field up to depth 31 takes one kernel-G'''
        launch a residency batch over every shard's mirror, and one fetch
        brings all of them back (_bsi_column_values)."""
        if not call.children or \
                call.children[0].name not in self._EXTRACT_FILTERS:
            raise ExecError("Extract() requires a filter call")
        filt_call = call.children[0]
        rows_calls = [c for c in call.children[1:] if c.name == "Rows"]
        flds = [self._field_or_err(index, c.args.get("_field")
                                   or c.args.get("field"))
                for c in rows_calls]
        tfields = [ExtractedTableField(name=f.name, type=_extract_type(f))
                   for f in flds]
        col_ids: list = []
        field_values: List[list] = [[] for _ in flds]
        shard_list = sorted(self._shards(index, shards))
        shard_cols = self._filter_columns(index, filt_call, shard_list)
        on_device = self._bsi_column_values(index, flds, shard_cols,
                                            shard_list)
        for shard, cols in shard_cols:
            for fi, f in enumerate(flds):
                field_values[fi].extend(self._extract_field_values(
                    f, shard, cols, on_device.get(fi)))
            col_ids.extend((cols + shard * SHARD_WIDTH).tolist())
        if index.options.keys and col_ids:
            keys = index.translate_store.translate_ids(col_ids)
            col_ids = [k if k is not None else c
                       for c, k in zip(col_ids, keys)]
        for fi, f in enumerate(flds):
            if f.options.keys and not f.is_bsi():
                vals = field_values[fi]
                ids = sorted({int(r) for v in vals
                              for r in (v if isinstance(v, list)
                                        else ([v] if v is not None else []))})
                lut = dict(zip(ids, index.row_translation(f.name)
                               .translate_ids(ids)))
                field_values[fi] = [
                    [lut.get(r) for r in v] if isinstance(v, list)
                    else (lut.get(v) if v is not None and
                          f.options.type == TYPE_MUTEX else v)
                    for v in vals]
        return ExtractedTable(tfields, col_ids=col_ids,
                              field_values=field_values)

    def _filter_columns(self, index: Index, filt_call: Call,
                        shard_list: List[int]) -> List[tuple]:
        """(shard, matched columns within the shard, int64 ascending) of
        each shard of `shard_list` (in its order) that the filter matches:
        from the host existence rows for All(), else from one stacked plan
        (kernel A) fetched once, else from the interpreter a shard,
        fetched once.  On one thread: on the card the worker pool made
        this 1.02-1.73 times slower (PERF.md §6)."""
        filt_rows = None
        ef = index.existence_field()
        if filt_call.name == "All" and not filt_call.args and \
                ef is not None and index.options.track_existence:
            v0 = ef.view(VIEW_STANDARD)
            filt_rows = {s: (fr.host_row(0) if (fr := v0 and v0.fragment(s))
                             is not None else
                             np.zeros(WORDS_PER_ROW, dtype=np.uint32))
                         for s in shard_list}
        elif shard_list and filt_call.name != "All":
            stacked = self._mesh_filter(index, filt_call, shard_list)
            if stacked is not None and self.mesh is not None:
                stacked.require_whole("Extract")
                filt_rows = {s: host_words(w) for s, w in
                             stacked.rows(torch.device("cpu")).items()}
            elif stacked is not None:
                arr = host_words(stacked)
                filt_rows = {s: arr[si] for si, s in enumerate(shard_list)}
        if filt_rows is None:
            filt_rows = dict(zip(shard_list, self._host_shard_words(
                index, filt_call, shard_list)))

        shard_cols = [(s, bw.words_to_cols(filt_rows[s]).astype(np.int64))
                      for s in shard_list]
        return [(s, c) for s, c in shard_cols if c.size]

    def _host_shard_words(self, index: Index, call: Call, shards
                          ) -> List[np.ndarray]:
        """The interpreter's words of `call` for each shard as uint32 host
        rows: computed on this thread, fetched once."""
        words = [self._bitmap_call_shard(index, call, s) for s in shards]
        return [w.astype(np.uint32) for w in _fetch(words)]

    def _bsi_column_values(self, index: Index, flds: List[Field], shard_cols,
                           shard_list: List[int]
                           ) -> Dict[int, Dict[int, tuple]]:
        """Kernel G''' values of each BSI field up to depth 31 at every
        shard's matched columns (shard_cols: (shard, columns) pairs): one
        launch per field and residency batch over the mirrors of the
        shards with data, one fetch for all -> {field index: {shard:
        (values, null)}}; a shard without data is left out.  On a mesh,
        one launch per field and member over the rows of its block of the
        stacked group (over `shard_list`, the query's shards) that have
        matched columns."""
        shards = [s for s, _ in shard_cols]
        cols_of = dict(shard_cols)
        launches = []
        for fi, f in enumerate(flds):
            if not f.is_bsi() or \
                    max(f.bit_depth, 1) > decode.DEVICE_MAX_DEPTH:
                continue
            if self.mesh is not None:
                if not shards:
                    continue
                bsi = self.plan_executor.stacked_bsi(
                    index, f.name, max(f.bit_depth, 1), shard_list)
                bsi.require_whole("Extract")
                for k, block in enumerate(bsi.blocks):
                    at = [(i, s) for i, s in enumerate(bsi.shards_of(k))
                          if s in cols_of]
                    if at:
                        launches.append((fi, [s for _, s in at],
                                         ck.bsi_decode_gather_sharded(
                                             [block[i] for i, _ in at],
                                             [cols_of[s] for _, s in at])))
                continue
            for live, groups, _ in self._shard_group_batches(
                    None, f, None, shards):
                launches.append((fi, live, ck.bsi_decode_gather_sharded(
                    groups, [cols_of[s] for s in live])))
        host = iter(_fetch([x for *_, pair in launches for x in pair]))
        out: Dict[int, Dict[int, tuple]] = {}
        for fi, live, _ in launches:
            va, ok = next(host), next(host)
            f, at = flds[fi], 0
            for s in live:
                n = cols_of[s].size
                vals, null = va[at:at + n] + f.base, ok[at:at + n] == 0
                if f.options.type == TYPE_DECIMAL:
                    vals = vals / float(10 ** f.options.scale)
                out.setdefault(fi, {})[s] = (vals, null)
                at += n
        return out

    def _extract_field_values(self, f: Field, shard: int, cols: np.ndarray,
                              on_device: Optional[Dict[int, tuple]] = None
                              ) -> List[Any]:
        """One field's values at a shard's matched columns, as a list: a
        BSI, bool or mutex field's value (None where it has none), a set or
        time field's sorted row ids.  `on_device`: the field's
        _bsi_column_values, when it has them."""
        if f.is_bsi() and on_device is not None:
            vals, null = on_device.get(shard) or (
                np.zeros(cols.size, np.int64), np.ones(cols.size, bool))
            out = vals.tolist()
            if null.any():
                out = [None if m else v for v, m in zip(out, null.tolist())]
            return out
        if f.is_bsi() or f.options.type in (TYPE_BOOL, TYPE_MUTEX):
            vals, null = self._field_shard_columns(f, shard, cols)
            out = vals.tolist()
            if null.any():
                out = [None if m else v for v, m in zip(out, null.tolist())]
            return out
        acc: List[List[int]] = [[] for _ in range(cols.size)]
        v = f.view(VIEW_STANDARD)
        frag = v.fragment(shard) if v else None
        rows = frag.slot_rows() if frag else []
        if not rows:
            return acc
        bits = self._row_bits(frag, rows, cols)
        rows_arr = np.asarray(rows, dtype=np.int64)
        for ci, ri in zip(*(x.tolist() for x in np.nonzero(bits.T))):
            acc[ci].append(int(rows_arr[ri]))
        return [sorted(x) for x in acc]

    @staticmethod
    def _row_bits(frag, rows, cols: np.ndarray) -> np.ndarray:
        """(R, N) bits of each row at each column, from the host masters."""
        word_idx = (cols >> 5).astype(np.int64)
        bit_idx = (cols & 31).astype(np.uint32)
        sub = np.stack([frag.host_row(r)[word_idx] for r in rows])
        return (sub >> bit_idx[None, :]) & 1

    def _field_shard_columns(self, f: Field, shard: int, cols: np.ndarray):
        """(values, null) arrays of one field at a shard's matched columns
        (JAX executor.py:634): a BSI field's values past depth 31 from the
        host decode (shallower ones come from _bsi_column_values); a bool
        or mutex field's first set row."""
        n = cols.size
        absent = np.zeros(n, np.int64), np.ones(n, dtype=bool)
        if f.is_bsi():
            dense = f.values_dense_host(shard)
            if dense is None:
                return absent
            vals_d, exists_b = dense
            vals, null = vals_d[cols] + f.base, ~exists_b[cols]
            if f.options.type == TYPE_DECIMAL:
                return vals / float(10 ** f.options.scale), null
            return vals, null
        v = f.view(VIEW_STANDARD)
        frag = v.fragment(shard) if v else None
        rows = frag.slot_rows() if frag else []
        if not rows:
            return absent
        bits = self._row_bits(frag, rows, cols)
        vals = np.asarray(rows, dtype=np.int64)[bits.argmax(axis=0)]
        if f.options.type == TYPE_BOOL:
            vals = vals.astype(bool)
        return vals, ~bits.any(axis=0)


    # ----------------------------------------------------- Apply / Arrow

    def _execute_apply(self, index: Index, call: Call,
                       shards: Optional[List[int]]) -> List[Any]:
        """Apply(filter?, "program"[, "reduce"]) (reference apply.go:121
        executeApply, an ivy program a shard and IvyReduce; JAX
        executor.py:527): a SQL expression over the values of the fields
        it names, a value a matched record, or one reduce (sum, mean,
        count, min, max).  The columnar route (_apply_vectorized) runs
        where every field it reads is a BSI, bool or unkeyed mutex field;
        else each record is evaluated on its own over Extract's table."""
        prog = call.args.get("_ivy")
        if not prog:
            raise ExecError("Apply() requires a program string")
        from featurebase_tpu_torch.sql.ops import eval_expr
        from featurebase_tpu_torch.sql.parser import Lexer, SQLError, _expr
        from featurebase_tpu_torch.sql.vector import referenced_columns
        try:
            expr = _expr(Lexer(prog))
        except SQLError as e:
            raise ExecError(f"Apply program: {e}")
        filt_call = call.children[0] if call.children else Call("All")
        # only the fields the program reads are gathered
        refs = referenced_columns(expr)
        fields = [f.name for f in index.public_fields() if f.name in refs]
        reduce = call.args.get("_ivyReduce")
        vec = self._apply_vectorized(index, expr, filt_call, fields, refs,
                                     shards, reduce)
        if vec is not None:
            return vec
        ext = Call("Extract", children=[filt_call] +
                   [Call("Rows", {"_field": fn}) for fn in fields])
        tbl = self._execute_extract(index, ext, shards)
        values: List[Any] = []
        for colrec in tbl.columns:
            env = {"_id": colrec.column}
            for fi, f in enumerate(tbl.fields):
                env[f.name] = colrec.rows[fi]
            try:
                values.append(eval_expr(expr, env))
            except Exception as e:  # noqa: BLE001
                raise ExecError(f"Apply program: {e}")
        if reduce:
            return [self._apply_reduce(reduce, values)]
        return values

    def _apply_vectorized(self, index: Index, expr, filt_call: Call, fields,
                          refs, shards, reduce) -> Optional[List[Any]]:
        """Apply over whole numpy columns (sql/vector.py), or None for the
        per-record route (set, time or keyed fields, or a construct the
        columnar evaluator does not take).  The filter's matched columns
        come from one stacked plan (kernel A; the interpreter a shard where
        the compiler refuses it), each BSI field's values up to depth 31
        from one kernel-G''' launch a residency batch over every shard's
        mirror, deeper ones from the host decode; records in the JAX
        package's order, shard by shard, columns ascending."""
        from featurebase_tpu_torch.sql.vector import (VecFallback,
                                                      VecRuntimeError,
                                                      eval_vec, reduce_vec)
        flds = [self._field_or_err(index, fn) for fn in fields]
        names = {f.name for f in flds}
        if any(r != "_id" and r not in names for r in refs):
            return None  # unknown column: the per-record route raises
        for f in flds:
            t = f.options.type
            if not (f.is_bsi() or t == TYPE_BOOL or
                    (t == TYPE_MUTEX and not f.options.keys)):
                return None
        shard_list = self._shards(index, shards)
        shard_cols = self._filter_columns(index, filt_call, shard_list)
        on_device = self._bsi_column_values(index, flds, shard_cols,
                                            shard_list)
        n = sum(cols.size for _, cols in shard_cols)
        ids = np.concatenate([cols + shard * SHARD_WIDTH
                              for shard, cols in shard_cols]) \
            if shard_cols else np.zeros(0, dtype=np.int64)
        env = {"_id": (ids, np.zeros(n, dtype=bool))}
        for fi, f in enumerate(flds):
            parts = []
            for shard, cols in shard_cols:
                if fi in on_device:
                    parts.append(on_device[fi].get(shard) or (
                        np.zeros(cols.size, np.int64),
                        np.ones(cols.size, dtype=bool)))
                else:
                    parts.append(self._field_shard_columns(f, shard, cols))
            env[f.name] = (np.concatenate([p[0] for p in parts]),
                           np.concatenate([p[1] for p in parts])) \
                if parts else (np.zeros(0, dtype=np.int64),
                               np.zeros(0, dtype=bool))
        try:
            vals, null = eval_vec(expr, env, n)
        except VecFallback:
            return None
        except VecRuntimeError as e:
            raise ExecError(f"Apply program: {e}")
        if reduce:
            try:
                return [reduce_vec(reduce, vals, null)]
            except VecRuntimeError as e:
                raise ExecError(str(e))
        out = vals.tolist()
        if null.any():
            out = [None if m else v for v, m in zip(out, null.tolist())]
        return out

    @staticmethod
    def _apply_reduce(kind: str, values: List[Any]):
        nums = [v for v in values if isinstance(v, (int, float))
                and not isinstance(v, bool)]
        kind = kind.strip().lower()
        if kind == "count":
            return len(values)
        if kind == "sum":
            return sum(nums)
        if kind == "mean":
            return sum(nums) / len(nums) if nums else None
        if kind == "min":
            return min(nums) if nums else None
        if kind == "max":
            return max(nums) if nums else None
        raise ExecError(f"Apply reduce must be sum|mean|count|min|max, "
                        f"got {kind!r}")

    def _execute_arrow(self, index: Index, call: Call,
                       shards: Optional[List[int]]) -> Dict[str, Any]:
        """Arrow(filter?) (reference arrow.go:36 executeArrow, 366
        executeArrowShard; JAX executor.py:722): the index's dataframe
        side-store, each shard's rows whose _id the filter matches.  The
        filter is one stacked plan over the shards that hold a dataframe
        (_filter_columns)."""
        if index._dataframe is None:
            raise ExecError("index has no dataframe data")
        filt_call = call.children[0] if call.children else None
        names = index.dataframe.column_names()
        out: Dict[str, list] = {n: [] for n in names}
        frames = [(s, df) for s in self._shards(index, shards)
                  if (df := index.dataframe.shard(s)) is not None]
        matched = None
        if filt_call is not None:
            matched = dict(self._filter_columns(index, filt_call,
                                                [s for s, _ in frames]))
        for shard, df in frames:
            ids = None
            if matched is not None:
                ids = matched.get(shard, np.zeros(0, dtype=np.int64)) + \
                    shard * SHARD_WIDTH
            cols = df.filtered(ids)
            n = len(cols.get("_id", []))
            for name in names:
                v = cols.get(name)
                out[name].extend(
                    [x.item() if hasattr(x, "item") else x for x in v]
                    if v is not None else [None] * n)
        return {"headers": names, "columns": out}

    def _execute_external_lookup(self, index: Index, call: Call,
                                 shards: Optional[List[int]]):
        """ExternalLookup(bitmap, query="...", write=bool) (reference
        executor.go:4357; JAX executor.py:2210): the bitmap's columns (its
        keys on a keyed index) bound as the $1 array of a SQL statement on
        the holder's lookup database (storage/lookup.py); a read comes back
        as an ExtractedTable whose first SQL column is the record."""
        db = getattr(self.holder, "lookup_db", None)
        if db is None:
            raise ExecError("external DB connection is not configured")
        query = call.args.get("query")
        if not isinstance(query, str):
            raise ExecError("missing query")
        if len(call.children) != 1:
            raise ExecError("ExternalLookup takes exactly one lookup input")
        write = bool(call.args.get("write", False))
        row = self._execute_call(index, call.children[0], shards)
        row = self._translate_result(index, call.children[0], row)
        if not isinstance(row, Row):
            raise ExecError("lookup input must be a bitmap call")
        if getattr(row, "keys", None):
            arg: list = list(row.keys)
        else:
            arg = [int(c) for c in row.columns()]
        if not arg:
            return ExtractedTable([], [])
        if write:
            db.execute(query, arg)
            return ExtractedTable([], [])
        header, rows = db.query(query, arg)
        fields = [ExtractedTableField(n, t) for n, t in header[1:]]
        columns = []
        for r in rows:
            if r[0] is None:
                raise ExecError("missing primary key in lookup result")
            columns.append(ExtractedTableColumn(r[0], list(r[1:])))
        return ExtractedTable(fields, columns)

    # ------------------------------------------- query memory accounting

    def enforce_memory_limit(self, index_name: str, parsed, shards,
                             limit: int):
        """Reject a query whose device working set would pass `limit`
        bytes (reference server/config.go:153 MaxQueryMemory; JAX
        executor.py:298): the stacked tiles a call must hold (bitmap
        leaves, BSI planes, candidate row tiles) and Extract's and Sort's
        host results, the JAX package's estimate."""
        index = self.holder.index(index_name)
        if index is None:
            return
        S = max(len(self._shards(index, shards)), 1)
        for call in parsed.calls:
            est = self._estimate_call_memory(index, call, S)
            if est > limit:
                raise ExecError(
                    f"query needs ~{est} bytes of device memory, over "
                    f"max-query-memory={limit}")

    def _estimate_call_memory(self, index: Index, call: Call, S: int) -> int:
        row_bytes = WORDS_PER_ROW * 4
        name = call.name

        def field_rows(fname) -> int:
            # candidate-row tiles stack the union of row ids across shards
            f = index.field(fname)
            v = f.view(VIEW_STANDARD) if f is not None else None
            if v is None:
                return 0
            union: set = set()
            for fr in v.fragments.values():
                union.update(fr.slot_rows())
            return len(union)

        def field_planes(fname) -> int:
            f = index.field(fname)
            return (max(f.bit_depth, 1) + 2) if f is not None else 0

        total = 0
        if name in ("Row", "Range"):
            fld, val = call.field_arg()
            f = index.field(fld) if fld else None
            if f is not None and (f.is_bsi() or isinstance(val, Condition)):
                total += field_planes(fld) * S * row_bytes
            else:
                total += S * row_bytes
        elif name in ("TopN", "TopK", "Distinct", "Rows"):
            fld = call.args.get("_field") or call.args.get("field")
            f = index.field(fld) if fld else None
            if f is not None and f.is_bsi():
                total += field_planes(fld) * S * row_bytes
            else:
                total += field_rows(fld) * S * row_bytes
        elif name == "GroupBy":
            for rc in call.children:
                if rc.name == "Rows":
                    fld = rc.args.get("_field") or rc.args.get("field")
                    total += field_rows(fld) * S * row_bytes
            agg = call.args.get("aggregate")
            if isinstance(agg, Call):
                afld = agg.args.get("_field") or agg.args.get("field")
                if afld:
                    total += field_planes(afld) * S * row_bytes
        elif name in ("Sum", "Min", "Max", "Sort", "Percentile"):
            fld = call.args.get("_field") or call.args.get("field")
            if fld:
                total += field_planes(fld) * S * row_bytes
            if name == "Sort" and call.args.get("limit") is None:
                # an unlimited Sort holds every present (column, value)
                # pair on the host (reference executor.go:6665)
                total += self._existing_columns_estimate(index) * 32
        elif name == "Extract":
            for rc in call.children[1:]:
                fld = rc.args.get("_field") or rc.args.get("field")
                f = index.field(fld) if fld else None
                if f is None:
                    continue
                if f.is_bsi():
                    total += field_planes(fld) * S * row_bytes
                else:
                    total += field_rows(fld) * S * row_bytes
            # host result rows: bounded by a Limit() filter, else every
            # existing column
            rows_est = self._existing_columns_estimate(index)
            if call.children:
                first = call.children[0]
                if first.name == "Limit" and first.args.get("limit") \
                        is not None:
                    rows_est = min(rows_est, int(first.args["limit"]))
            total += rows_est * 16 * max(len(call.children) - 1, 1)
        skip_children = set()
        if name in ("GroupBy", "Extract"):
            skip_children = {id(c) for c in call.children
                             if c.name == "Rows"}
        for ch in call.children:
            if id(ch) not in skip_children:
                total += self._estimate_call_memory(index, ch, S)
        for k, v in call.args.items():
            if isinstance(v, Call) and not (name == "GroupBy"
                                            and k == "aggregate"):
                total += self._estimate_call_memory(index, v, S)
        return total

    @staticmethod
    def _existing_columns_estimate(index: Index) -> int:
        """Columns that exist in the index, from the existence field's host
        words; every shard full without existence tracking."""
        ef = index.existence_field()
        if ef is None:
            return max(len(index.available_shards()), 1) * SHARD_WIDTH
        v = ef.view(VIEW_STANDARD)
        if v is None:
            return 0
        return sum(int(np.bitwise_count(frag.host_row(0)).sum())
                   for frag in list(v.fragments.values()))

def _extract_type(f: Field) -> str:
    """Extract's column type of a field (reference executeExtract)."""
    t = f.options.type
    if t in (TYPE_SET, TYPE_TIME):
        return "[]string" if f.options.keys else "[]id"
    if t == TYPE_MUTEX:
        return "string" if f.options.keys else "id"
    return {TYPE_BOOL: "bool", TYPE_DECIMAL: "decimal",
            TYPE_TIMESTAMP: "timestamp"}.get(t, "int64")
