"""Distributed query execution: scatter-gather over cluster nodes.

Own copy of featurebase_tpu/cluster/distributed.py.  Each node runs its
shard subset on its own executor (its CUDA device or mesh, with the port's
kernels) and the partials merge exactly at the coordinator.  Mirrors the
reference's mapReduce (reference: executor.go:6449 mapReduce,
6579 mapper, 6392 remoteExec, 6487-6533 streaming reduce with replica
failover).  The coordinator:

1. pre-translates keys cluster-wide (writes route to key-partition
   primaries; reference executor.go:6814 preTranslate),
2. precomputes nested Distinct/UnionRows/Limit filters globally and embeds
   them as Precomputed rows (reference: handlePreCalls executor.go:364,
   makeEmbeddedDataForShards:6537),
3. groups shards by their first live owner (jump-hash placement,
   topology.py), executes locally for its own shards and POSTs the
   translated AST to peers for theirs,
4. reduces partial results associatively as they arrive; a connection
   failure marks the node DOWN and re-maps its shards onto the next live
   replica (reference: executor.go:6503).

Per-call distribution contracts that differ from naive merging:
- TopN/TopK: the per-node `n` cut is removed so counts merge exactly, then
  the coordinator sorts and truncates (the reference achieves exactness
  with a second recount pass, executor.go:2779-2830; shipping full pair
  lists gives the same result in one round trip).
- GroupBy: having/limit are held back and applied after the group merge
  (reference: mergeGroupCounts executor.go:3728 + satisfiesCondition:3787).
- Percentile: one node's bisection runs at the coordinator over the nodes'
  kernel-I' bins added up (_execute_percentile), or, off the device
  route, the reference's, every probe a distributed Count (reference
  executor.go:1310).
- Var and Corr: each node returns its moments (the call's _moments form),
  which sum exactly across nodes, and the coordinator finishes them as one
  node does (Executor.var_of, corr_of).  The JAX package's cluster cannot
  encode a node's float answer and fails these calls.
- Apply and Arrow: each node answers a partial a shard (the _byShard form
  of Executor.execute_remote), which the coordinator joins in shard order,
  the order one node gives; the JAX package's cluster joins whole node
  partials in the order they arrive.
- Limit: each node keeps offset + limit columns of its shards, and the
  coordinator cuts the union to the window; the JAX package's cluster
  unions the nodes' windows (a window a node).
"""
from __future__ import annotations

import copy
from concurrent import futures
from typing import Any, Dict, List, Optional

import torch

from featurebase_tpu_torch.cluster.client import NodeUnreachable
from featurebase_tpu_torch.cluster.cluster import Cluster
from featurebase_tpu_torch.cluster.wire import decode_result, encode_call
from featurebase_tpu_torch.core.consts import SHARD_WIDTH
from featurebase_tpu_torch.ops import decode
from featurebase_tpu_torch.executor.executor import ExecError, Executor
from featurebase_tpu_torch.executor.results import (ExtractedTable,
                                                    GroupCount, Pair,
                                                    PairField, PairsField,
                                                    ValCount)
from featurebase_tpu_torch.model.field import TYPE_BOOL, TYPE_DECIMAL
from featurebase_tpu_torch.model.index import Index
from featurebase_tpu_torch.model.row import Row, SignedRow
from featurebase_tpu_torch.pql.ast import WRITE_CALLS, Call, Condition, Query
from featurebase_tpu_torch.pql.parser import parse as pql_parse

# calls whose results are precomputed + embedded when nested as filters
PRE_CALLS = ("Distinct", "UnionRows", "Limit")


class DistributedExecutor:
    def __init__(self, api, cluster: Cluster):
        self.api = api
        self.cluster = cluster
        self.executor: Executor = api.executor

    # ------------------------------------------------------------------ entry

    def execute(self, index_name: str, query,
                shards: Optional[List[int]] = None) -> List[Any]:
        index = self.api.holder.index(index_name)
        if index is None:
            raise ExecError(f"index not found: {index_name}")
        if isinstance(query, str):
            query = pql_parse(query)
        results = []
        for call in query.calls:
            self.executor._validate_call(index, call)
            call = self._pre_translate(index, call)
            self._handle_pre_calls(index, index_name, call, top=True)
            if call.name in WRITE_CALLS:
                result = self._execute_write(index, index_name, call)
            else:
                result = self._execute_read(index, index_name, call, shards)
            results.append(
                self.executor._translate_result(index, call, result))
        return results

    # --------------------------------------------------- cluster pre-translate

    def _pre_translate(self, index: Index, call: Call) -> Call:
        """Key->ID with cluster routing: creates go to partition primaries
        (reference: executor.go:6814 preTranslate)."""
        is_write = call.name in WRITE_CALLS
        col = call.args.get("_col")
        if isinstance(col, str):
            if not index.options.keys:
                raise ExecError("string column key on unkeyed index")
            if is_write:
                call.args["_col"] = self.cluster.route_create_index_keys(
                    self.api, index.name, [col])[col]
            else:
                call.args["_col"] = index.translate_store.find_keys(
                    [col]).get(col, -1)
        # record-key args (ConstRow columns / Rows-IncludesColumn column)
        # translate read-side on keyed indexes, like the local executor
        if index.options.keys:
            cols_arg = call.args.get("columns")
            if call.name == "ConstRow" and isinstance(cols_arg, list) and \
                    any(isinstance(c, str) for c in cols_arg):
                skeys = [c for c in cols_arg if isinstance(c, str)]
                found = index.translate_store.find_keys(skeys)
                call.args["columns"] = [
                    found.get(c, -1) if isinstance(c, str) else c
                    for c in cols_arg]
            colf = call.args.get("column")
            if isinstance(colf, str):
                call.args["column"] = index.translate_store.find_keys(
                    [colf]).get(colf, -1)
        for k, v in list(call.args.items()):
            f = index.field(k)
            if f is None:
                continue
            if isinstance(v, str) and f.options.keys:
                if is_write:
                    v_id = self.cluster.route_create_field_keys(
                        self.api, index.name, k, [v])[v]
                else:
                    store = index.row_translation(k)
                    v_id = store.find_keys([v]).get(v, -1)
                call.args[k] = v_id
            elif isinstance(v, str) and f.options.foreign_index:
                # string values are record keys of the foreign index
                # (reference: field.go foreign index)
                fidx = self.api.holder.index(f.options.foreign_index)
                if fidx is None:
                    raise ExecError(
                        f"foreign index not found: {f.options.foreign_index}")
                if is_write:
                    v_id = self.cluster.route_create_index_keys(
                        self.api, fidx.name, [v])[v]
                else:
                    v_id = fidx.translate_store.find_keys([v]).get(v, -1)
                call.args[k] = v_id
            elif isinstance(v, bool) and f.options.type == TYPE_BOOL:
                call.args[k] = 1 if v else 0
        for i, ch in enumerate(call.children):
            call.children[i] = self._pre_translate(index, ch)
        for k, v in list(call.args.items()):
            if isinstance(v, Call):
                call.args[k] = self._pre_translate(index, v)
        return call

    # ------------------------------------------------------------- pre-calls

    def _handle_pre_calls(self, index: Index, index_name: str, call: Call,
                          top: bool = False):
        """Replace nested Distinct/UnionRows/Limit with embedded Precomputed
        rows computed cluster-wide (reference: handlePreCalls
        executor.go:364)."""
        if not top and call.name in PRE_CALLS:
            result = self._execute_read(index, index_name, call, None)
            if isinstance(result, SignedRow):
                result = result.pos
            if not isinstance(result, Row):
                raise ExecError(f"cannot embed {call.name} result as filter")
            call.name, call.args, call.children = \
                "Precomputed", {"_row": result}, []
            return
        for ch in call.children:
            if call.name == "Count" and ch.name == "Distinct":
                # Count(Distinct(...)) counts signed values exactly — handled
                # in _execute_read, not embedded (reference: executeCount's
                # Distinct fast path, executor.go:5839)
                continue
            self._handle_pre_calls(index, index_name, ch)
        for v in call.args.values():
            if isinstance(v, Call):
                self._handle_pre_calls(index, index_name, v)

    # ----------------------------------------------------------------- writes

    def _execute_write(self, index: Index, index_name: str, call: Call):
        snap = self.cluster.snapshot
        if call.name in ("Set", "Clear"):
            col = call.args.get("_col")
            if col is None:
                raise ExecError(f"{call.name}() requires a column")
            shard = int(col) // SHARD_WIDTH
            owners = snap.shard_nodes(index_name, shard)
            self.cluster.note_shards(index_name, [shard])
            live = [n for n in owners if n.state != "DOWN"]
            if not live:
                raise ExecError("no live replica owns shard "
                                f"{shard} of {index_name}")

            # all replicas written concurrently; an unreachable replica is
            # marked DOWN and the write succeeds on the rest — resync
            # reconciles it on rejoin (reference: internal_client.go:691
            # importNode fan-out; holderSyncer holder.go:1303)
            def write_one(n):
                try:
                    return self._exec_on_node(n, index_name, call, [shard])
                except NodeUnreachable:
                    self.cluster.mark_down(n.id)
                    return None
            with futures.ThreadPoolExecutor(max_workers=len(live)) as pool:
                rs = list(pool.map(write_one, live))
            succeeded = [r for r in rs if r is not None]
            if not succeeded:
                raise ExecError("no live replica accepted the write for "
                                f"shard {shard} of {index_name}")
            return any(bool(r) for r in succeeded)
        # Store / ClearRow / Delete touch every shard: each live replica
        # applies it to the shards it owns, as Set and Clear are applied
        # (the JAX package's cluster sends it to the first live owner of
        # each shard alone, and the other replicas keep the old rows)
        shards = self.cluster.all_shards(self.api, index_name)
        by_node: Dict[str, List[int]] = {}
        for s in shards:
            live = [n for n in snap.shard_nodes(index_name, s)
                    if n.state != "DOWN"]
            if not live:
                raise ExecError(
                    f"shard {s} of {index_name} has no live replica")
            for n in live:
                by_node.setdefault(n.id, []).append(s)

        def write_node(kv):
            try:
                return self._exec_on_node(snap.node(kv[0]), index_name,
                                          call, kv[1])
            except NodeUnreachable:
                self.cluster.mark_down(kv[0])
                return NodeUnreachable
        with futures.ThreadPoolExecutor(
                max_workers=max(1, len(by_node))) as pool:
            rs = dict(zip(by_node, pool.map(write_node, by_node.items())))
        applied = {s for nid, r in rs.items() if r is not NodeUnreachable
                   for s in by_node[nid]}
        if set(shards) - applied:
            raise ExecError("no live replica accepted the write for shards "
                            f"{sorted(set(shards) - applied)} of "
                            f"{index_name}")
        result: Any = None
        for r in rs.values():
            if r is not NodeUnreachable:
                result = self._merge(index, call, result, r)
        return result if result is not None else True

    # ------------------------------------------------------------------ reads

    def _execute_read(self, index: Index, index_name: str, call: Call,
                      shards: Optional[List[int]]):
        name = call.name
        if name == "Options":
            return self._execute_read(index, index_name, call.children[0],
                                      shards)
        if name == "Percentile":
            return self._execute_percentile(index, index_name, call, shards)
        if name in ("Var", "Corr"):
            fanout = copy.deepcopy(call)
            fanout.args["_moments"] = True
            m = self.map_reduce(index, index_name, fanout, shards)["moments"]
            ex = self.executor
            if name == "Corr":
                return ex.corr_of(*ex.corr_fields(index, call), *m)
            fld = call.args.get("_field") or call.args.get("field")
            return ex.var_of(ex._field_or_err(index, fld), *m)
        if name == "Count" and call.children \
                and call.children[0].name == "Distinct":
            inner = self._execute_read(index, index_name, call.children[0],
                                       shards)
            if isinstance(inner, SignedRow):
                return inner.neg.count() + inner.pos.count()
            return inner.count()
        if name in ("IncludesColumn", "FieldValue"):
            col = call.args.get("column")
            if col is None:
                raise ExecError(f"{name}() requires a column argument")
            if isinstance(col, str):
                col = index.translate_store.find_keys([col]).get(col, -1)
                call.args["column"] = col
            if int(col) < 0:
                # an unknown key: one node's answer over no shards (the JAX
                # package's cluster fails hashing shard -1)
                return self.executor.execute_remote(index.name,
                                                    Query([call]), [])[0]
            shard = int(col) // SHARD_WIDTH
            owners = self.cluster.snapshot.shard_nodes(index_name, shard)
            node = self.cluster.first_live(owners)
            if node is None:
                raise ExecError(f"no live replica owns shard {shard}")
            return self._exec_on_node(node, index_name, call, [shard])

        # hold back coordinator-side post-processing args
        fanout = call
        post: Dict[str, Any] = {}
        if name in ("TopN", "TopK"):
            fanout = copy.deepcopy(call)
            post["n"] = fanout.args.pop("n", None) or fanout.args.pop("k", None)
        elif name == "GroupBy":
            fanout = copy.deepcopy(call)
            post["limit"] = fanout.args.pop("limit", None)
            post["having"] = fanout.args.pop("having", None)
        elif name == "Sort":
            fanout = copy.deepcopy(call)
            post["limit"] = fanout.args.pop("limit", None)
            post["offset"] = fanout.args.pop("offset", 0)
            post["desc"] = bool(fanout.args.get("sort-desc",
                                                fanout.args.get("desc", False)))
            if post["limit"] is not None:
                # per-node top-(offset+limit) pushdown: the global cut is
                # a subset of each node's prefix (executor.go:9321)
                fanout.args["limit"] = int(post["offset"]) \
                    + int(post["limit"])
            else:
                # unlimited: chunked streaming instead of one message
                # holding every (col, val) pair of a node
                result = self._sort_unlimited(index_name, fanout, shards)
                return self._post_process(index, call, result, post)
        elif name == "Apply":
            # reduce at the coordinator after gather (reference: IvyReduce,
            # apply.go:50)
            fanout = copy.deepcopy(call)
            post["reduce"] = fanout.args.pop("_ivyReduce", None)
            fanout.args["_byShard"] = True
        elif name == "Arrow":
            fanout = copy.deepcopy(call)
            fanout.args["_byShard"] = True
        elif name == "Limit":
            fanout = copy.deepcopy(call)
            post["limit"] = fanout.args.get("limit")
            post["offset"] = int(fanout.args.pop("offset", 0) or 0)
            if post["limit"] is not None:
                fanout.args["limit"] = post["offset"] + int(post["limit"])

        result = self.map_reduce(index, index_name, fanout, shards)
        return self._post_process(index, call, result, post)

    def map_reduce(self, index: Index, index_name: str, call: Call,
                   shards: Optional[List[int]] = None):
        """Concurrent scatter per-owner, streaming reduce, replica failover.

        All owner nodes are queried in parallel (reference: executor.go:6579
        mapper launches one goroutine per node) and partial results are
        merged in completion order as they arrive (reference:
        executor.go:6487-6533 streaming reduce).  A connection failure marks
        the node DOWN and resubmits its shards to their next live replicas
        without cancelling in-flight work.
        """
        if shards is None:
            shards = self.cluster.all_shards(self.api, index_name)
        pending = self._group_shards(index_name, shards)
        acc = None
        first = True
        with futures.ThreadPoolExecutor(
                max_workers=max(4, len(pending))) as pool:
            inflight: Dict[futures.Future, tuple] = {}

            def submit(nid: str, node_shards: List[int]):
                node = self.cluster.snapshot.node(nid)
                fut = pool.submit(self._exec_on_node, node, index_name,
                                  call, node_shards)
                inflight[fut] = (nid, node_shards)

            for nid, node_shards in pending.items():
                submit(nid, node_shards)
            while inflight:
                done, _ = futures.wait(
                    inflight, return_when=futures.FIRST_COMPLETED)
                for fut in done:
                    nid, node_shards = inflight.pop(fut)
                    try:
                        partial = fut.result()
                    except NodeUnreachable:
                        self.cluster.mark_down(nid)
                        # re-map this node's shards onto next live replicas
                        regroup = self._group_shards(index_name, node_shards)
                        for k, v in regroup.items():
                            submit(k, v)
                        continue
                    if first:
                        acc, first = partial, False
                    else:
                        acc = self._merge(index, call, acc, partial)
        if first:
            # no shards: execute locally on nothing for a typed zero value
            acc = self.executor.execute_remote(index.name,
                                               Query([call]), [])[0]
        return acc

    def _group_shards(self, index_name: str,
                      shards: List[int]) -> Dict[str, List[int]]:
        snap = self.cluster.snapshot
        by_node: Dict[str, List[int]] = {}
        for s in shards:
            owners = snap.shard_nodes(index_name, s)
            node = self.cluster.first_live(owners)
            if node is None:
                raise ExecError(
                    f"shard {s} of {index_name} has no live replica")
            by_node.setdefault(node.id, []).append(s)
        return by_node

    def _exec_on_node(self, node, index_name: str, call: Call,
                      shards: List[int]):
        if self.cluster.is_self(node):
            return self.api.query_remote_local(index_name, Query([call]),
                                               shards)[0]
        out = self.cluster.client.query_node(
            node.uri, index_name, [encode_call(call)], shards)
        return decode_result(out[0])

    # ------------------------------------------------------------------ merge

    def _merge(self, index: Index, call: Call, a, b):
        """Associative partial-result merge (reference: reduceFn per call;
        Row.Merge row.go:202, ValCount.Add, Pairs.Add, mergeGroupCounts)."""
        if a is None:
            return b
        if b is None:
            return a
        if call.name in ("Var", "Corr"):
            return {"moments": [x + y for x, y in zip(a["moments"],
                                                       b["moments"])]}
        if call.args.get("_byShard"):
            return {"byShard": {**a["byShard"], **b["byShard"]}}
        if "_thresholds" in call.args:   # Percentile's bins of a round
            x, y = a["pctCounts"], b["pctCounts"]
            if x is None or y is None:
                return {"pctCounts": None}
            return {"pctCounts": [p + q for p, q in zip(x[:-2], y[:-2])]
                    + [min(x[-2], y[-2]), max(x[-1], y[-1])]}
        if isinstance(a, bool) and isinstance(b, bool):
            return a or b
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return a + b
        if isinstance(a, Row):
            return a.union(b)
        if isinstance(a, SignedRow):
            return a.union(b)
        if isinstance(a, ValCount):
            name = call.name
            if name == "Sum":
                return a.add(b)
            if name == "Min":
                return a.smaller(b)
            if name == "Max":
                return a.larger(b)
            return a.add(b)
        if isinstance(a, PairField):  # MinRow / MaxRow
            if b.pair.count == 0:
                return a
            if a.pair.count == 0:
                return b
            pick_min = call.name == "MinRow"
            if a.pair.id == b.pair.id:
                return PairField(Pair(a.pair.id,
                                      a.pair.count + b.pair.count), a.field)
            take_a = (a.pair.id < b.pair.id) == pick_min
            return a if take_a else b
        if isinstance(a, PairsField):
            counts: Dict[int, int] = {}
            for p in a.pairs + b.pairs:
                counts[p.id] = counts.get(p.id, 0) + p.count
            pairs = [Pair(i, c) for i, c in counts.items()]
            pairs.sort(key=lambda p: (-p.count, p.id))
            return PairsField(pairs, a.field)
        if isinstance(a, list) and (not a or isinstance(a[0], GroupCount)) \
                and (not b or isinstance(b[0], GroupCount)):
            if (a and isinstance(a[0], GroupCount)) or \
                    (b and isinstance(b[0], GroupCount)):
                return self._merge_group_counts(a, b)
        if isinstance(a, list) and isinstance(b, list):
            return sorted(set(a) | set(b))
        if isinstance(a, ExtractedTable):
            # per-node partials arrive sorted by record id: linear k-way
            # style merge instead of re-sorting the accumulated table on
            # every node (reference: executor.go:9574 k-way merge); a keyed
            # index's records carry their keys, which merge in the order of
            # their ids, as one node orders them (the JAX package's cluster
            # merges the keys as strings)
            import heapq
            keys = [c.column for c in a.columns + b.columns
                    if isinstance(c.column, str)]
            ids = index.translate_store.find_keys(keys) if keys else {}
            a.columns = list(heapq.merge(
                a.columns, b.columns,
                key=lambda c: ids.get(c.column, -1)
                if isinstance(c.column, str) else c.column))
            return a
        if isinstance(a, dict) and "columns" in a:  # Sort partials
            return self._merge_sorted(call, a, b)
        raise ExecError(f"cannot merge partial results of type {type(a)}")

    @staticmethod
    def _merge_group_counts(a: List[GroupCount],
                            b: List[GroupCount]) -> List[GroupCount]:
        merged: Dict[tuple, GroupCount] = {}
        for gc in list(a) + list(b):
            key = tuple(fr.sort_key() for fr in gc.group)
            cur = merged.get(key)
            if cur is None:
                merged[key] = GroupCount(gc.group, gc.count, gc.agg,
                                         gc.decimal_agg)
            else:
                cur.count += gc.count
                cur.agg += gc.agg
                if gc.decimal_agg is not None:
                    cur.decimal_agg = (cur.decimal_agg or 0) + gc.decimal_agg
        return [merged[k] for k in sorted(merged)]

    # page size for unlimited distributed Sort streaming; tests shrink it
    SORT_STREAM_CHUNK = 100_000

    def _sort_unlimited(self, index_name: str, fanout: Call,
                        shards: Optional[List[int]]) -> dict:
        """Chunked streaming for UNLIMITED distributed Sort: every node
        ships bounded pages, resumed by KEYSET cursor — each page passes
        after=[stored_value, column] of the previous page's last record, so
        writes landing between pages cannot shift, drop, or duplicate
        records the way limit/offset pagination could.  Pages concatenate in order per node and the runs
        k-way merge at the coordinator (reference merge:
        executor.go:9574).  A node failure mid-stream re-streams that
        node's shards from their next live replicas."""
        import heapq
        if shards is None:
            shards = self.cluster.all_shards(self.api, index_name)
        fld = fanout.args.get("_field") or fanout.args.get("field")
        f = self.api.holder.index(index_name).field(fld)
        pending = self._group_shards(index_name, shards)
        runs: List[tuple] = []
        for nid, node_shards in pending.items():
            cols: Optional[list] = []
            vals: list = []
            cursor = None  # (stored_value, column) of last record seen
            while True:
                pc = copy.deepcopy(fanout)
                pc.args["limit"] = self.SORT_STREAM_CHUNK
                pc.args.pop("offset", None)
                if cursor is not None:
                    pc.args["after"] = [cursor[0], cursor[1]]
                node = self.cluster.snapshot.node(nid)
                try:
                    part = self._exec_on_node(node, index_name, pc,
                                              node_shards)
                except NodeUnreachable:
                    self.cluster.mark_down(nid)
                    sub = self._sort_unlimited(index_name, fanout,
                                               node_shards)
                    runs.append((sub["columns"], sub["values"]))
                    cols = None
                    break
                cols.extend(part["columns"])
                vals.extend(part["values"])
                if len(part["columns"]) < self.SORT_STREAM_CHUNK:
                    break
                # stored value = decoded value re-encoded (exact for int/
                # timestamp; decimal round-trips through the fixed scale)
                cursor = (f.encode_value(part["values"][-1]),
                          int(part["columns"][-1]))
            if cols is not None:
                runs.append((cols, vals))
        desc = bool(fanout.args.get("sort-desc",
                                    fanout.args.get("desc", False)))

        def key(cv):
            return ((-cv[1] if desc else cv[1]), cv[0])
        merged = list(heapq.merge(*[zip(c, v) for c, v in runs], key=key))
        return {"columns": [c for c, _ in merged],
                "values": [v for _, v in merged]}

    @staticmethod
    def _merge_sorted(call: Call, a: dict, b: dict) -> dict:
        """Linear merge of two already-sorted runs (each node's partial is
        sorted; reference k-way merge executor.go:9574), truncated to
        offset+limit when the call bounds the result."""
        import heapq
        desc = bool(call.args.get("sort-desc", call.args.get("desc", False)))

        def key(cv):
            return ((-cv[1] if desc else cv[1]), cv[0])
        merged = heapq.merge(zip(a["columns"], a["values"]),
                             zip(b["columns"], b["values"]), key=key)
        limit = call.args.get("limit")
        if limit is not None:
            keep = int(call.args.get("offset", 0)) + int(limit)
            pairs = []
            for cv in merged:
                pairs.append(cv)
                if len(pairs) >= keep:
                    break
        else:
            pairs = list(merged)
        return {"columns": [c for c, _ in pairs],
                "values": [v for _, v in pairs]}

    # ----------------------------------------------------------- post-process

    @staticmethod
    def _join_arrow(a: dict, b: dict) -> dict:
        headers = list(dict.fromkeys(a["headers"] + b["headers"]))
        cols = {}
        for h in headers:
            cols[h] = list(a["columns"].get(h, [])) + \
                list(b["columns"].get(h, []))
        return {"headers": headers, "columns": cols}

    def _post_process(self, index: Index, call: Call, result, post: dict):
        name = call.name
        if isinstance(result, dict) and "byShard" in result:
            parts = [result["byShard"][k]
                     for k in sorted(result["byShard"], key=int)]
            if name == "Apply":
                # per-shard program outputs concatenate (reference:
                # IvyReduce happens after gather, apply.go:50)
                result = [x for p in parts for x in p]
            else:
                result = {"headers": [], "columns": {}}
                for p in parts:
                    result = self._join_arrow(result, p)
        if name == "Limit" and isinstance(result, Row):
            cols = result.columns()[post["offset"]:]
            if post["limit"] is not None:
                cols = cols[: int(post["limit"])]
            return Row.from_columns(cols)
        if name in ("TopN", "TopK") and isinstance(result, PairsField):
            n = post.get("n")
            if n:
                result.pairs = result.pairs[: int(n)]
            return result
        if name == "GroupBy" and isinstance(result, list):
            having = post.get("having")
            if isinstance(having, Call):
                result = self.executor._apply_having(result, having)
            limit = post.get("limit")
            if limit is not None:
                result = result[: int(limit)]
            return result
        if name == "Sort" and isinstance(result, dict):
            offset = int(post.get("offset") or 0)
            limit = post.get("limit")
            cols, vals = result["columns"], result["values"]
            if offset:
                cols, vals = cols[offset:], vals[offset:]
            if limit is not None:
                cols, vals = cols[: int(limit)], vals[: int(limit)]
            return {"columns": cols, "values": vals}
        if name == "Rows" and isinstance(result, list):
            limit = call.args.get("limit")
            if limit is not None:
                result = result[: int(limit)]
            return result
        if name == "Apply" and post.get("reduce"):
            return [self.executor._apply_reduce(post["reduce"], result)]
        return result

    # ------------------------------------------------------------- percentile

    def _execute_percentile(self, index: Index, index_name: str, call: Call,
                            shards: Optional[List[int]]):
        """The coordinator runs one node's bisection (ops/decode.py
        percentile) over the cluster's counts: each round asks every node
        for kernel I's bins of the round's thresholds over its shards and
        adds them up, so the probes are one node's, exact rationals
        included.  Where a node cannot take the device route (a filter the
        plan compiler refuses, a field past depth 31), the reference's
        bisection runs at the coordinator, every probe a distributed Count
        (reference executor.go:1310), with the exact rational thresholds
        one node tests (the JAX package's cluster tests float64 ones)."""
        nth = call.args.get("nth")
        if nth is None:
            raise ExecError("Percentile(): nth required")
        nth = float(nth)
        if nth < 0 or nth > 100:
            raise ExecError("Percentile(): nth must be in [0, 100]")
        fld = call.args.get("_field") or call.args.get("field")
        f = index.field(fld)
        if f is None:
            raise ExecError(f"field not found: {fld}")

        class NoDeviceRoute(Exception):
            pass

        def counts(_vals, _exists, _filt, _base, thresholds):
            leg = copy.deepcopy(call)
            leg.args["_thresholds"] = [int(t) for t in thresholds]
            got = self.map_reduce(index, index_name, leg, shards)
            if got["pctCounts"] is None:
                raise NoDeviceRoute
            return torch.tensor(got["pctCounts"], dtype=torch.int64)
        try:
            val, cnt = decode.percentile(None, None, None, int(f.base), nth,
                                         counts)
            return None if cnt == 0 else \
                self.executor._wrap_valcount(f, val, cnt)
        except NoDeviceRoute:
            pass
        filt = call.args.get("filter")
        filt_children = [filt] if isinstance(filt, Call) else []

        def count_of(cond: Optional[Condition]) -> int:
            row_call = Call("Row", {fld: cond if cond is not None
                                    else Condition("!=", None)})
            inner = row_call
            if filt_children:
                inner = Call("Intersect",
                             children=[row_call] + copy.deepcopy(filt_children))
            return self.map_reduce(index, index_name,
                                   Call("Count", children=[inner]), shards)

        total = count_of(None)
        if total == 0:
            return None
        num, den = decode.nth_ratio(nth)
        desired_less = total * num // den
        desired_greater = total * (den - num) // den
        minc = Call("Min", {"_field": fld},
                    children=copy.deepcopy(filt_children))
        maxc = Call("Max", {"_field": fld},
                    children=copy.deepcopy(filt_children))
        if desired_greater != 0:
            min_vc = self.map_reduce(index, index_name, minc, shards)
            if desired_less == 0:
                return min_vc
        max_vc = self.map_reduce(index, index_name, maxc, shards)
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
        return self.executor._wrap_valcount(f, possible, 1)
