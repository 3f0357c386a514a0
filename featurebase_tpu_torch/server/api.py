"""API facade over a Holder and the port's executor, single node.

Own copy of featurebase_tpu/server/api.py (reference: api.go:45 API; Query
:209, CreateIndex :254, CreateField :372, Import :1438, ImportValue :1771,
schema.go): the entry point of the HTTP and gRPC handlers, ingest and the
SQL engine.  ``API(...)`` runs its Executor on CUDA unless the caller
passes ``device="cpu"``, and raises without CUDA; ``API(mesh=...)`` runs it
over a mesh of members (parallel/mesh.py), on the mesh's first local
member unless `device` names another.

Durability is the JAX package's, in its formats: with ``data_dir`` every
mutation is appended to a WAL (storage/wal.py) before it is applied,
startup restores the newest snapshot (storage/snapshot.py) and replays the
log, and ``checkpoint()`` cuts a new snapshot and truncates the log.  A WAL
or a snapshot written by either package's API loads in the other's.

Roaring import and export (``import_roaring``, ``import_roaring_shard``,
``export_roaring``) run through the native codec (ingest/roaring_import.py)
and log ``roaring`` WAL entries in the JAX package's form.

Not ported yet, and raising NotImplementedError that names its item of
ROADMAP.md queue 1: the cluster (``cluster=``, the control plane, key
replication, remote queries, shard snapshots and restore, resync: item
14); WAL entries of that kind (``schema_log``, ``schema_term``), which a
replay counts as failed entries.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from featurebase_tpu_torch.executor.executor import ExecError, Executor
from featurebase_tpu_torch.model.field import (TYPE_BOOL, TYPE_MUTEX,
                                               FieldOptions)
from featurebase_tpu_torch.model.index import Holder, Index, IndexOptions


class APIError(Exception):
    def __init__(self, msg: str, status: int = 400):
        super().__init__(msg)
        self.status = status


def not_ported(item: int, what: str) -> NotImplementedError:
    """The error for `what`, which waits for ROADMAP.md queue 1 `item`."""
    area = {14: "the cluster", 15: "DAX"}[item]
    return NotImplementedError(
        f"{what} needs {area}, which featurebase_tpu_torch does not run yet "
        f"(ROADMAP.md queue 1 item {item})")


class API:
    """The single-node API (see the module docstring)."""

    # Above this fraction of failed replay entries (with a small absolute
    # floor) startup fails loud instead of serving silently-lossy state.
    WAL_REPLAY_ERROR_FRACTION = 0.1
    WAL_REPLAY_ERROR_FLOOR = 3

    def __init__(self, holder: Optional[Holder] = None, mesh=None,
                 path: str = "", data_dir: Optional[str] = None,
                 cluster=None, long_query_time: Optional[float] = None,
                 query_history_length: int = 100,
                 max_query_memory: Optional[int] = None,
                 query_timeout: Optional[float] = None,
                 max_writes_per_request: Optional[int] = None,
                 device=None):
        from featurebase_tpu_torch import __version__
        from featurebase_tpu_torch.ingest.idalloc import IDAllocator
        from featurebase_tpu_torch.utils.logger import DEFAULT
        from featurebase_tpu_torch.utils.monitor import (DiagnosticsCollector,
                                                         ErrorMonitor)
        from featurebase_tpu_torch.utils.tracker import (QueryTracker,
                                                         TransactionStore)
        if cluster is not None:
            raise not_ported(14, "API(cluster=)")
        self.data_dir = data_dir
        self.auth = None        # token authn + group authz (server/auth.py)
        self.idalloc = IDAllocator()
        self.wal = None
        self._replaying = False
        self.logger = DEFAULT
        self.tracker = QueryTracker(query_history_length, long_query_time,
                                    self.logger)
        self.max_query_memory = max_query_memory
        self.query_timeout = query_timeout
        # reference: server/config.go:103 MaxWritesPerRequest
        self.max_writes_per_request = max_writes_per_request
        self.transactions = TransactionStore()
        self.monitor = ErrorMonitor(version=__version__)
        self.diagnostics = DiagnosticsCollector(self, version=__version__)
        if data_dir:
            from featurebase_tpu_torch.storage import snapshot as snap
            from featurebase_tpu_torch.storage.wal import WAL
            snap_dir = os.path.join(data_dir, "snapshot")
            holder = snap.load(snap_dir, idalloc=self.idalloc) \
                if os.path.isdir(snap_dir) else (holder or Holder(path))
            self.holder = holder
            self.executor = Executor(self.holder, device=device, mesh=mesh)
            self.wal = WAL(os.path.join(data_dir, "wal.jsonl"))
            self._replay_wal()
        else:
            self.holder = holder or Holder(path)
            self.executor = Executor(self.holder, device=device, mesh=mesh)

    # -- durability ---------------------------------------------------------

    def _logging(self) -> bool:
        """Whether _log writes (a bulk import builds its entry only
        then)."""
        return self.wal is not None and not self._replaying

    def _log(self, entry: dict):
        if self._logging():
            self.wal.append(entry)

    def _replay_wal(self):
        """Replay the WAL, counting (not swallowing) each failed entry: it
        is logged, the total lands in the wal_replay_errors counter, and
        past WAL_REPLAY_ERROR_FRACTION of the entries startup raises."""
        from featurebase_tpu_torch.utils.metrics import REGISTRY
        self._replaying = True
        self.wal_replay_errors = 0
        applied = 0

        def apply(e: dict):
            nonlocal applied
            try:
                self._apply_wal_entry(e)
                applied += 1
            except Exception as ex:  # noqa: BLE001 — counted + surfaced
                self.wal_replay_errors += 1
                self.logger.error("wal replay failed (op=%s): %s",
                                  e.get("op"), ex)

        try:
            self.wal.replay(apply)
        finally:
            self._replaying = False
        if self.wal_replay_errors:
            REGISTRY.count("wal_replay_errors", self.wal_replay_errors)
            total = applied + self.wal_replay_errors
            if (self.wal_replay_errors >= self.WAL_REPLAY_ERROR_FLOOR
                    and self.wal_replay_errors >
                    self.WAL_REPLAY_ERROR_FRACTION * total):
                raise RuntimeError(
                    f"WAL replay dropped {self.wal_replay_errors}/{total} "
                    "entries; refusing to serve silently-lossy state "
                    "(restore from snapshot or clear the WAL)")

    def _apply_wal_entry(self, e: dict):
        from featurebase_tpu_torch.storage.wal import decode_bytes
        op = e["op"]
        if op == "pql":
            self.executor.execute(e["i"], e["q"])
        elif op == "create_index":
            self.create_index(e["name"], e.get("options"), if_not_exists=True)
        elif op == "delete_index":
            self.holder.delete_index(e["name"])
        elif op == "create_field":
            self.create_field(e["i"], e["f"], e.get("options"),
                              if_not_exists=True)
        elif op == "delete_field":
            idx = self.holder.index(e["i"])
            if idx is not None:
                idx.delete_field(e["f"])
        elif op == "bits":
            self.import_bits(e["i"], e["f"], e["rows"], e["cols"],
                             timestamps=e.get("ts"),
                             clear=e.get("clear", False),
                             row_keys=e.get("rowKeys"),
                             col_keys=e.get("colKeys"))
        elif op == "vals":
            self.import_values(e["i"], e["f"], e["cols"], e["values"],
                               clear=e.get("clear", False),
                               col_keys=e.get("colKeys"))
        elif op == "roaring":
            from featurebase_tpu_torch.ingest.roaring_import import (
                import_roaring, import_roaring_shard)
            idx = self.holder.index(e["i"])
            view = e.get("view", "standard")
            if idx is not None and e.get("replace"):
                import_roaring_shard(idx, e["shard"], {
                    f"{e['f']}/{view}": {"data": decode_bytes(e["data"]),
                                         "clear": e.get("clear", False),
                                         "replace": True}})
            elif idx is not None:
                import_roaring(idx, e["f"], e["shard"],
                               decode_bytes(e["data"]), view=view,
                               clear=e.get("clear", False))
        elif op == "pql_ast":
            from featurebase_tpu_torch.cluster.wire import decode_query
            self.executor.execute(e["i"], decode_query(e["q"]))
        elif op == "keys":
            idx = self.holder.index(e["i"])
            if idx is not None:
                store = (idx.row_translation(e["f"]) if e.get("f")
                         else idx.translate_store)
                if store is not None:
                    store.apply_entries(e["entries"])
        elif op == "create_view":
            self.holder.sql_views[e["name"]] = e["sql"]
        elif op == "delete_view":
            self.holder.sql_views.pop(e["name"], None)
        elif op == "create_database":
            self.holder.sql_databases[e["name"]] = e.get("options", {})
        elif op == "drop_database":
            self.holder.sql_databases.pop(e["name"], None)
        elif op == "create_function":
            self.holder.sql_functions[e["name"]] = e["def"]
        elif op == "drop_function":
            self.holder.sql_functions.pop(e["name"], None)
        elif op == "dataframe":
            idx = self.holder.index(e["i"])
            if idx is not None:
                if "columns" in e:
                    idx.dataframe.ingest_json(e["shard"], e["columns"])
                else:
                    idx.dataframe.ingest_parquet(
                        e["shard"], decode_bytes(e["parquet"]))
        elif op in ("schema_log", "schema_term"):
            raise not_ported(14, f"a {op} WAL entry")
        else:
            raise ValueError(f"unknown WAL op: {op!r}")

    def checkpoint(self):
        """Snapshot + truncate WAL."""
        if not self.data_dir:
            raise APIError("server is not durable (no data dir)", 400)
        from featurebase_tpu_torch.storage import snapshot as snap
        snap.save(self.holder, os.path.join(self.data_dir, "snapshot"),
                  idalloc=self.idalloc)
        self.wal.truncate()

    # -- schema -------------------------------------------------------------

    def create_index(self, name: str, options: Optional[dict] = None,
                     if_not_exists: bool = False) -> Index:
        try:
            idx = self.holder.create_index(
                name, IndexOptions.from_json(options or {}),
                if_not_exists=if_not_exists)
        except ValueError as e:
            raise APIError(str(e), 409)
        self._log({"op": "create_index", "name": name, "options": options})
        return idx

    def delete_index(self, name: str):
        if self.holder.index(name) is None:
            raise APIError(f"index not found: {name}", 404)
        self.holder.delete_index(name)
        self._log({"op": "delete_index", "name": name})

    def create_field(self, index: str, field: str,
                     options: Optional[dict] = None,
                     if_not_exists: bool = False):
        idx = self._index(index)
        opts = FieldOptions.from_json(options or {})
        self._validate_field_options(opts)
        if opts.foreign_index and self.holder.index(opts.foreign_index) \
                is None:
            # reference: field.go foreign-index validation at create time
            raise APIError(
                f"foreign index not found: {opts.foreign_index}", 400)
        try:
            f = idx.create_field(field, opts, if_not_exists=if_not_exists)
        except ValueError as e:
            raise APIError(str(e), 409)
        self._log({"op": "create_field", "i": index, "f": field,
                   "options": options})
        return f

    @staticmethod
    def _validate_field_options(opts):
        """Reject malformed field options at create time (reference:
        field.go applyOption, time.go:44 TimeQuantum.Valid)."""
        if opts.min is not None and opts.max is not None and \
                opts.min > opts.max:
            raise APIError(
                f"field min ({opts.min}) greater than max ({opts.max})",
                400)
        if opts.cache_type not in ("ranked", "lru", "none"):
            raise APIError(
                f"invalid cache type: {opts.cache_type!r}", 400)
        if not 0 <= opts.scale <= 19:
            raise APIError(
                f"decimal scale must be in [0, 19], got {opts.scale}", 400)
        tq = opts.time_quantum
        if tq and tq not in ("Y", "YM", "YMD", "YMDH", "M", "MD", "MDH",
                             "D", "DH", "H"):
            # only contiguous granularity runs (time.go:44)
            raise APIError(f"invalid time quantum: {tq!r}", 400)
        if opts.ttl and not tq:
            raise APIError("ttl requires a time quantum", 400)

    def delete_field(self, index: str, field: str):
        idx = self._index(index)
        if idx.field(field) is None:
            raise APIError(f"field not found: {field}", 404)
        idx.delete_field(field)
        self._log({"op": "delete_field", "i": index, "f": field})

    def create_sql_view(self, name: str, select_sql: str,
                        if_not_exists: bool = False):
        """Register a SQL view (reference: sql3 CREATE VIEW; kept on the
        holder, in snapshots and in the WAL)."""
        if name in self.holder.sql_views and not if_not_exists:
            raise APIError(f"view already exists: {name}", 409)
        self.holder.sql_views[name] = select_sql
        self._log({"op": "create_view", "name": name, "sql": select_sql})

    def delete_sql_view(self, name: str, if_exists: bool = False):
        if name not in self.holder.sql_views:
            if if_exists:
                return
            raise APIError(f"view not found: {name}", 404)
        del self.holder.sql_views[name]
        self._log({"op": "delete_view", "name": name})

    def schema(self) -> list:
        return self.holder.schema()

    def apply_schema(self, schema: list):
        self.holder.apply_schema(schema)

    def _index(self, name: str) -> Index:
        idx = self.holder.index(name)
        if idx is None:
            raise APIError(f"index not found: {name}", 404)
        return idx

    # -- query --------------------------------------------------------------

    def check_write_allowed(self, tx_id: Optional[str] = None):
        """An active exclusive transaction blocks writes from everyone but
        its holder (reference: api.go StartTransaction)."""
        excl = self.transactions.active_exclusive()
        if excl is not None and excl.id != tx_id:
            raise APIError(
                f"write blocked by exclusive transaction {excl.id!r}", 409)

    def query(self, index: str, pql: str,
              shards: Optional[List[int]] = None) -> List[Any]:
        return self.query_full(index, pql, shards=shards)["results"]

    def query_full(self, index: str, pql: str,
                   shards: Optional[List[int]] = None,
                   transaction_id: Optional[str] = None) -> Dict[str, Any]:
        """Query with the tracker, metrics and, under
        Options(profile=true), a profile tree of its calls (reference:
        executor.go:227-236; api.go:209 Query, long-query log api.go:2089);
        held to max_writes_per_request, max_query_memory and
        query_timeout."""
        from featurebase_tpu_torch.executor.qcontext import (QueryCanceled,
                                                             QueryContext,
                                                             QueryTimeout)
        from featurebase_tpu_torch.pql.ast import WRITE_CALLS
        from featurebase_tpu_torch.pql.parser import ParseError
        from featurebase_tpu_torch.pql.parser import parse as _parse
        from featurebase_tpu_torch.utils.metrics import REGISTRY
        from featurebase_tpu_torch.utils.tracing import TRACER
        self._index(index)
        qtext = pql if isinstance(pql, str) else repr(pql)
        qid = self.tracker.start(index, qtext, "")
        REGISTRY.count("query_total", index=index)
        err: Optional[str] = None
        try:
            with REGISTRY.timer("query_seconds", index=index):
                parsed = _parse(pql) if isinstance(pql, str) else pql
                n_writes = sum(1 for c in parsed.calls
                               if c.name in WRITE_CALLS)
                if n_writes:
                    self.check_write_allowed(transaction_id)
                    if self.max_writes_per_request and \
                            n_writes > self.max_writes_per_request:
                        raise APIError(
                            f"query has {n_writes} write calls, over "
                            "max-writes-per-request="
                            f"{self.max_writes_per_request}", 400)
                profile = any(c.name == "Options"
                              and c.args.get("profile") in (True, 1)
                              for c in parsed.calls)
                pctx = TRACER.start_profile("query", index=index) \
                    if profile else None
                qctx = QueryContext(timeout=self.query_timeout,
                                    cancel_ev=self.tracker.cancel_event(qid))
                try:
                    with qctx:
                        if self.max_query_memory:
                            self.executor.enforce_memory_limit(
                                index, parsed, shards,
                                self.max_query_memory)
                        self._log_write_calls(index, parsed)
                        results = self.executor.execute(index, parsed,
                                                        shards=shards)
                finally:
                    if pctx is not None:
                        pctx.__exit__()
                out: Dict[str, Any] = {"results": results}
                if pctx is not None:
                    out["profile"] = pctx.profile()
                return out
        except ParseError as e:
            err = f"parsing: {e}"
            raise APIError(err, 400)
        except QueryCanceled as e:
            err = str(e)
            raise APIError(err, 499)
        except QueryTimeout as e:
            err = str(e)
            raise APIError(err, 408)
        except ExecError as e:
            err = str(e)
            raise APIError(err, 400)
        finally:
            self.tracker.finish(qid, err)

    def _log_write_calls(self, index: str, parsed):
        from featurebase_tpu_torch.pql.ast import WRITE_CALLS
        if self.wal is not None and any(
                c.name in WRITE_CALLS for c in parsed.calls):
            from featurebase_tpu_torch.cluster.wire import encode_query
            self._log({"op": "pql_ast", "i": index,
                       "q": encode_query(parsed)})

    # -- imports (reference api.go:1438 Import, 1771 ImportValue) ------------

    def import_bits(self, index: str, field: str, rows, cols,
                    timestamps=None, clear: bool = False,
                    row_keys=None, col_keys=None):
        self.check_write_allowed()
        idx = self._index(index)
        f = idx.field(field)
        if f is None:
            raise APIError(f"field not found: {field}", 404)
        if col_keys is not None:
            ids = self.create_index_keys(index, list(col_keys))
            cols = np.array([ids[k] for k in col_keys], dtype=np.int64)
        if row_keys is not None:
            ids = self.create_field_keys(index, field, list(row_keys))
            rows = np.array([ids[k] for k in row_keys], dtype=np.int64)
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if self._logging():
            self._log({"op": "bits", "i": index, "f": field,
                       "rows": rows.tolist(), "cols": cols.tolist(),
                       "ts": list(timestamps) if timestamps is not None
                       else None, "clear": clear})
        with idx.mutate_gate.shared():
            f.import_bits(rows, cols, timestamps=timestamps, clear=clear)
            if not clear:
                idx.mark_exists(cols)

    def import_values(self, index: str, field: str, cols, values,
                      clear: bool = False, col_keys=None):
        self.check_write_allowed()
        idx = self._index(index)
        f = idx.field(field)
        if f is None:
            raise APIError(f"field not found: {field}", 404)
        if not f.is_bsi():
            raise APIError(f"field {field} is not an int-like field", 400)
        if col_keys is not None:
            ids = self.create_index_keys(index, list(col_keys))
            cols = np.array([ids[k] for k in col_keys], dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if self._logging():
            self._log({"op": "vals", "i": index, "f": field,
                       "cols": cols.tolist(),
                       "values": [v if not isinstance(v, (np.integer,))
                                  else int(v) for v in values],
                       "clear": clear})
        with idx.mutate_gate.shared():
            f.import_values(cols, values, clear=clear,
                            device=self.executor.device)
            if not clear:
                idx.mark_exists(cols)

    # -- roaring import and export (reference api.go:618 ImportRoaring,
    # 1647 ImportRoaringShard; the /export endpoint) ----------------------

    def import_roaring(self, index: str, field: str, shard: int, data: bytes,
                       view: str = "standard", clear: bool = False,
                       forwarded: bool = False):
        """Merge (or clear) a roaring payload into one fragment, logged
        first as a ``roaring`` WAL entry.  `forwarded` is the cluster's
        flag; a single node ignores it."""
        from featurebase_tpu_torch.ingest.roaring_import import import_roaring
        from featurebase_tpu_torch.storage.wal import encode_bytes
        idx = self._index(index)
        if idx.field(field) is None:
            raise APIError(f"field not found: {field}", 404)
        self._log({"op": "roaring", "i": index, "f": field, "shard": shard,
                   "data": encode_bytes(data), "view": view, "clear": clear})
        with idx.mutate_gate.shared():
            import_roaring(idx, field, shard, data, view=view, clear=clear)

    def import_roaring_shard(self, index: str, shard: int, views: dict,
                             forwarded: bool = False):
        """Transactional multi-view import for one shard: `views` maps
        "<field>[/<view>]" to {"data": bytes, "clear": bool, "replace":
        bool}; one ``roaring`` WAL entry a view, with the view's resolved
        name ("bsig" is the field's BSI group) and "replace", so that a
        replay writes what was acknowledged (the JAX package's replay
        reads neither and merges into the view as named)."""
        from featurebase_tpu_torch.ingest.roaring_import import \
            import_roaring_shard
        from featurebase_tpu_torch.storage.wal import encode_bytes
        idx = self._index(index)
        if self.wal is not None and not self._replaying:
            for spec, payload in views.items():
                fname = spec.split("/", 1)[0]
                vname = spec.split("/", 1)[1] if "/" in spec else "standard"
                if vname == "bsig":
                    vname = f"bsig_{fname}"
                self._log({"op": "roaring", "i": index, "f": fname,
                           "shard": shard,
                           "data": encode_bytes(payload.get("data", b"")),
                           "view": vname,
                           "clear": payload.get("clear", False),
                           "replace": bool(payload.get("replace", False))})
        with idx.mutate_gate.shared():
            import_roaring_shard(idx, shard, views)

    def export_roaring(self, index: str, field: str, shard: int,
                       view: str = "standard") -> bytes:
        """One fragment as a reference-compatible roaring payload."""
        from featurebase_tpu_torch.ingest.roaring_import import export_roaring
        idx = self._index(index)
        if idx.field(field) is None:
            raise APIError(f"field not found: {field}", 404)
        return export_roaring(idx, field, shard, view=view)

    # -- translation --------------------------------------------------------

    def create_index_keys(self, index: str, keys: List[str]) -> Dict[str, int]:
        entries = self._index(index).translate_store.create_keys(keys)
        self._log({"op": "keys", "i": index, "f": "", "entries": entries})
        return entries

    def find_index_keys(self, index: str, keys: List[str]) -> Dict[str, int]:
        return self._index(index).translate_store.find_keys(keys)

    def create_field_keys(self, index: str, field: str,
                          keys: List[str]) -> Dict[str, int]:
        store = self._index(index).row_translation(field)
        if store is None:
            raise APIError("field does not use keys", 400)
        entries = store.create_keys(keys)
        self._log({"op": "keys", "i": index, "f": field, "entries": entries})
        return entries

    def find_field_keys(self, index: str, field: str,
                        keys: List[str]) -> Dict[str, int]:
        store = self._index(index).row_translation(field)
        if store is None:
            raise APIError("field does not use keys", 400)
        return store.find_keys(keys)

    # -- ID allocation (reference api.go:2460 ReserveIDs, 2475 CommitIDs) ----

    def reserve_ids(self, index: str, key: str, session: str, offset: int,
                    count: int):
        try:
            return self.idalloc.reserve(index, key, session.encode(), offset,
                                        count)
        except ValueError as e:
            raise APIError(str(e), 409)

    def commit_ids(self, index: str, key: str, session: str, offset: int,
                   count: int):
        try:
            self.idalloc.commit(index, key, session.encode(), offset, count)
        except ValueError as e:
            raise APIError(str(e), 409)

    def import_atomic_record(self, index: str, records: List[dict]):
        """Import whole records across many fields in one request
        (reference: api.go ImportAtomicRecord).  Every record is validated
        before any is applied, so a bad record rejects the request."""
        idx = self._index(index)
        plan = []
        for rec in records:
            col = rec.get("col")
            if col is None:
                raise APIError("atomic record requires 'col'", 400)
            sets = rec.get("sets") or {}
            values = rec.get("values") or {}
            for fname in list(sets) + list(values):
                f = idx.field(fname)
                if f is None:
                    raise APIError(f"field not found: {fname}", 404)
                if fname in values and not f.is_bsi():
                    raise APIError(f"field {fname} is not int-like", 400)
                if fname in sets and f.is_bsi():
                    raise APIError(f"field {fname} is int-like; use "
                                   "'values'", 400)
            plan.append((col, sets, values, rec.get("timestamp")))
        for col, sets, values, ts in plan:
            keyed = isinstance(col, str)
            for fname, rows in sets.items():
                rows = rows if isinstance(rows, list) else [rows]
                row_keys = [r for r in rows if isinstance(r, str)] or None
                row_ids = None if row_keys else rows
                self.import_bits(index, fname,
                                 rows=row_ids or [0] * len(rows),
                                 cols=[0] if keyed else [col] * len(rows),
                                 timestamps=[ts] * len(rows) if ts else None,
                                 row_keys=row_keys,
                                 col_keys=[col] * len(rows) if keyed
                                 else None)
            for fname, v in values.items():
                self.import_values(index, fname,
                                   cols=[0] if keyed else [col],
                                   values=[v],
                                   col_keys=[col] if keyed else None)

    # -- anti-entropy units, caches, dataframes ------------------------------

    def shard_fragment_checksums(self, index: str, shard: int) -> dict:
        """Per-fragment content checksums and a total mutation counter for
        one shard (the anti-entropy comparison unit).  The checksums equal
        the JAX package's over the same bits; the generations are this
        process's (they start at a per-fragment base, model/fragment.py)."""
        idx = self._index(index)
        frags = []
        total_gen = 0
        for f in idx.fields.values():
            for vname, v in f.views.items():
                frag = v.fragment(shard)
                if frag is None or frag.num_rows == 0:
                    continue
                frags.append({"field": f.name, "view": vname,
                              "checksum": frag.checksum(),
                              "rows": frag.num_rows})
                total_gen += frag.generation
        frags.sort(key=lambda d: (d["field"], d["view"]))
        return {"fragments": frags, "total_generation": total_gen}

    def recalculate_caches(self):
        """Drop every field's TopN rank cache, so the next ranked query
        counts afresh (reference: api.RecalculateCaches)."""
        for idx in self.holder.indexes.values():
            for f in idx.fields.values():
                f._topn_cache.clear()

    def dataframe_ingest(self, index: str, shard: int,
                         columns: Optional[dict] = None,
                         parquet: Optional[bytes] = None):
        """Append columnar rows to an index's per-shard dataframe store,
        WAL-durable (reference: /index/{i}/dataframe/{shard}
        http_handler.go:506)."""
        from featurebase_tpu_torch.storage.wal import encode_bytes
        idx = self._index(index)
        if columns is not None:
            idx.dataframe.ingest_json(shard, columns)
            self._log({"op": "dataframe", "i": index, "shard": shard,
                       "columns": {k: np.asarray(v).tolist()
                                   for k, v in columns.items()}})
        elif parquet is not None:
            idx.dataframe.ingest_parquet(shard, parquet)
            self._log({"op": "dataframe", "i": index, "shard": shard,
                       "parquet": encode_bytes(parquet)})

    def mutex_check(self, index: str, field: str,
                    limit: int = 1000) -> dict:
        """Columns violating the mutex invariant (more than one row set),
        as {column: [row ids]} (reference: api.go mutex-check)."""
        idx = self._index(index)
        f = idx.field(field)
        if f is None:
            raise APIError(f"field not found: {field}", 404)
        if f.options.type not in (TYPE_MUTEX, TYPE_BOOL):
            raise APIError(f"field {field} is not a mutex field", 400)
        out: dict = {}
        v = f.view("standard")
        if v is None:
            return out
        for shard, frag in sorted(v.fragments.items()):
            n = frag.num_rows
            if n < 2:
                continue
            rows = frag.slot_rows()
            words = frag._words[:n]
            bits = np.unpackbits(
                np.ascontiguousarray(words).view(np.uint8).reshape(n, -1),
                axis=1, bitorder="little")
            counts = bits.sum(axis=0)
            bad = np.nonzero(counts > 1)[0]
            for c in bad[:limit]:
                col = int(c) + shard * (1 << 20)
                out[col] = [int(rows[r]) for r in
                            np.nonzero(bits[:, c])[0]]
                if len(out) >= limit:
                    return out
        return out

    # -- TTL view removal (reference: server.go:920 ViewsRemoval) -----------

    def views_removal(self, now=None) -> Dict[str, List[str]]:
        """One pass of expired-time-view deletion across every field with
        a ttl (each view's device copies go with it); returns
        {index/field: [removed views]}."""
        removed: Dict[str, List[str]] = {}
        for iname in list(self.holder.indexes):
            idx = self.holder.index(iname)
            if idx is None:
                continue
            for f in list(idx.fields.values()):
                got = f.remove_expired_views(now)
                if got:
                    removed[f"{iname}/{f.name}"] = got
        return removed

    def start_views_removal(self, interval: float = 3600.0):
        """Background ticker (reference: server.go:902
        monitorViewsRemoval); returns the Event that stops it."""
        stop = threading.Event()

        def loop():
            while not stop.wait(interval):
                try:
                    self.views_removal()
                except Exception as ex:  # noqa: BLE001 — logged, retried
                    self.logger.error("views removal failed: %s", ex)
        threading.Thread(target=loop, daemon=True).start()
        self._views_removal_stop = stop
        return stop

    # -- info ---------------------------------------------------------------

    def available_shards(self, index: str) -> List[int]:
        return self._index(index).available_shards()

    def fragments_info(self, index: str) -> list:
        """Per-fragment inspector rows, under the JAX package's keys:
        field, view, shard, rows, seqlock generation, hostBytes (the host
        master's words, 0 while spilled), spilled (the host budget moved
        them to disk, storage/hostmem.py), deviceResident (the fragment's
        device mirror is held), deviceRows (the rows the mirror holds), dirtySlots (slots written
        since the mirror's last upload) and overlayRows (rows with MVCC
        copies kept for snapshot pins)."""
        idx = self._index(index)
        out = []
        for f in idx.fields.values():
            for vname, v in f.views.items():
                for shard, frag in sorted(v.fragments.items()):
                    w = frag._words_mem
                    out.append({
                        "field": f.name, "view": vname, "shard": shard,
                        "rows": frag.num_rows,
                        "generation": frag.generation,
                        "hostBytes": int(w.nbytes) if w is not None else 0,
                        "spilled": w is None,
                        "deviceResident": frag._dev is not None,
                        "deviceRows": max(frag._dev_rows, 0),
                        "dirtySlots": len(frag._dirty),
                        "overlayRows": len(frag._overlay),
                    })
        return out

    def status(self) -> dict:
        """Node state, indexes, the executor's torch device, or on a mesh
        each of its members in mesh order (with the card's name on CUDA),
        and the shard width."""
        mesh = self.executor.mesh
        devs = mesh.members if mesh is not None else [self.executor.device]

        def name(dev) -> str:
            if dev.type == "cuda":
                import torch
                return f"{dev} {torch.cuda.get_device_name(dev)}"
            return str(dev)
        return {"state": "NORMAL",
                "indexes": sorted(self.holder.indexes),
                "devices": [name(d) for d in devs],
                "shardWidth": 1 << 20}


# The JAX API's methods that need the cluster: each raises, naming its
# ROADMAP.md queue 1 item.
def _raising(item: int, name: str):
    def method(self, *args, **kwargs):
        raise not_ported(item, f"API.{name}")
    method.__name__ = name
    method.__doc__ = f"Not ported yet: ROADMAP.md queue 1 item {item}."
    return method


for _name in ("handle_cluster_message", "cluster_join", "cluster_remove",
              "rebalance_pull", "replicate_index_keys",
              "replicate_field_keys", "translate_snapshot",
              "apply_translate_snapshot", "primary_create_index_keys",
              "primary_create_field_keys", "query_remote_local",
              "query_remote", "shard_snapshot_bytes",
              "fragment_snapshot_bytes", "restore_fragment", "restore_shard",
              "resync_shards", "translate_checksums", "resync_translate"):
    setattr(API, _name, _raising(14, _name))
