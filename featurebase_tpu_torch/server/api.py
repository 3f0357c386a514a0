"""API facade over a Holder and the port's executor.

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

With ``cluster=`` (cluster/cluster.py) the API is one node of a cluster:
queries run through the DistributedExecutor (cluster/distributed.py), each
node over its own shards on its own device; schema changes go through the
replicated schema log (cluster/schemalog.py, logged as ``schema_log`` and
``schema_term`` WAL entries); writes, new keys and imports route to their
owners and replicas; and shard snapshots, their restore and the
anti-entropy passes (``resync_shards``, ``resync_translate``) keep the
replicas converged.
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


class API:
    """The API of a single node or of one cluster node (see the module
    docstring)."""

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
        from featurebase_tpu_torch.cluster.schemalog import SchemaLog
        from featurebase_tpu_torch.ingest.idalloc import IDAllocator
        from featurebase_tpu_torch.utils.logger import DEFAULT
        from featurebase_tpu_torch.utils.monitor import (DiagnosticsCollector,
                                                         ErrorMonitor)
        from featurebase_tpu_torch.utils.tracker import (QueryTracker,
                                                         TransactionStore)
        self.data_dir = data_dir
        self.cluster = cluster
        self.schema_log = SchemaLog()
        self._schema_commit_lock = threading.Lock()
        self.distributed = None
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
        if cluster is not None:
            from featurebase_tpu_torch.cluster.distributed import \
                DistributedExecutor
            self.distributed = DistributedExecutor(self, cluster)

    # -- durability ---------------------------------------------------------

    def _logging(self) -> bool:
        """Whether _log writes (a write builds its entry only then; a DAX
        computer, which logs to its writelogger, says so with no WAL)."""
        return self.wal is not None and not self._replaying

    def _log(self, entry: dict):
        if self._logging():
            self.wal.append(entry)

    def _log_all(self, entries: List[dict]):
        """Log the entries of one write in order (a roaring shard import's
        views)."""
        for e in entries:
            self._log(e)

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
        elif op == "schema_log":
            # the log's consensus state only: the schema's content replays
            # from its own per-op entries above
            self.schema_log.restore_entry(
                {"idx": e["idx"], "term": e.get("term", 0),
                 "op": e.get("sop", {})})
        elif op == "schema_term":
            self.schema_log.restore_term(e["term"], e.get("leader"))
        else:
            raise ValueError(f"unknown WAL op: {op!r}")

    # -- cluster control plane ------------------------------------------------

    def _broadcast(self, msg: dict):
        """Send a schema/control message to all peers (reference:
        broadcast.go SendSync; server.go:1109)."""
        if self.cluster is not None and not self._replaying \
                and not getattr(self, "_from_broadcast", False):
            self.cluster.broadcast(msg)

    # -- replicated schema log (cluster/schemalog.py; reference: etcd-raft
    # Schemator, disco/disco.go:92) ----------------------------------------

    def _should_route_schema(self) -> bool:
        # only the monolith Cluster runs the log; DAX topologies have the
        # controller's Schemar as their schema authority (dax/controller.py)
        return (self.cluster is not None
                and hasattr(self.cluster, "schema_leader")
                and not self._replaying
                and not getattr(self, "_from_broadcast", False))

    def _schema_op(self, op: dict):
        """Route a schema mutation through the replicated log: propose to
        the reachable leader; the leader quorum-gates, applies (validating),
        appends, and synchronously broadcasts the entry."""
        from featurebase_tpu_torch.cluster.client import (NodeUnreachable,
                                                    RemoteError)
        leader = self.cluster.schema_leader()
        if leader is None:
            raise APIError("no reachable schema leader", 503)
        if self.cluster.is_self(leader):
            return self._commit_schema_op(op)
        try:
            self.cluster.client.cluster_message(
                leader.uri, {"type": "schema_propose", "op": op})
        except NodeUnreachable as e:
            raise APIError(f"schema leader unreachable: {e}", 503)
        except RemoteError as e:
            raise APIError(str(e), e.status)
        return self._schema_result(op)

    def _ensure_schema_term(self):
        """Pre-commit quorum round (cluster/schemalog.py's terms):
        read every reachable peer's (term, applied, suffix); CATCH UP on
        entries committed while this node was away; when our term lease
        is stale (a peer has seen a newer term, or we never established
        one), establish term = max_seen + 1 by quorum vote.  A healed
        stale leader therefore either converges before committing or
        fails cleanly — it can never commit behind the majority."""
        from featurebase_tpu_torch.cluster.client import (NodeUnreachable,
                                                    RemoteError)
        cl = self.cluster
        self_id = cl.self_node.id
        views = []
        for p in cl.peers():
            try:
                views.append(cl.client._call(
                    p.uri, "GET",
                    f"/internal/schema/log?from={self.schema_log.applied}"))
            except (NodeUnreachable, RemoteError):
                views.append(None)
        live = 1 + sum(1 for v in views if v is not None)
        if live * 2 <= len(cl.nodes):
            raise APIError(
                "schema commit needs a reachable majority "
                f"({live}/{len(cl.nodes)})", 503)
        # catch up on anything a peer committed past us
        for v in views:
            if v and v.get("applied", 0) > self.schema_log.applied:
                for e in self.schema_log.install(v.get("entries", []),
                                                 v["applied"]):
                    self._apply_schema_msg(e["op"], lenient=True)
                    self._log({"op": "schema_log", "idx": e["idx"],
                               "term": e.get("term", 0), "sop": e["op"]})
        max_term = max([self.schema_log.term] +
                       [v.get("term", 0) for v in views if v])
        if self.schema_log.holds_term(self_id) and \
                self.schema_log.term >= max_term:
            return  # our lease is still the newest known term
        new_term = max_term + 1
        acks = 1  # self
        self.schema_log.accept_term(new_term, self_id)
        for p in cl.peers():
            try:
                cl.client.cluster_message(
                    p.uri, {"type": "schema_term", "term": new_term,
                            "leader": self_id})
                acks += 1
            except (NodeUnreachable, RemoteError):
                pass
        if acks * 2 <= len(cl.nodes):
            raise APIError(
                f"schema term {new_term} not accepted by a majority", 503)
        self._log({"op": "schema_term", "term": new_term,
                   "leader": self_id})

    def _commit_schema_op(self, op: dict):
        """Leader-side commit: term round (quorum + catch-up) ->
        validate+apply -> log+broadcast.  Nothing is logged when the
        apply raises (a 409 etc. reaches the proposer with the log
        untouched)."""
        with self._schema_commit_lock:
            self._ensure_schema_term()
            result = self._apply_schema_msg(op)
            entry = self.schema_log.append(op)
            self._log({"op": "schema_log", "idx": entry["idx"],
                       "term": entry["term"], "sop": op})
            self.cluster.broadcast(
                {"type": "schema_entry", **entry,
                 "origin_uri": self.cluster.self_node.uri})
        return result

    def _schema_result(self, op: dict):
        """Proposer-visible result after the leader's ack (the entry was
        applied locally during the leader's synchronous broadcast)."""
        t = op["type"]
        if t == "create_index":
            return self.holder.index(op["name"])
        if t == "create_field":
            idx = self.holder.index(op["index"])
            return idx.field(op["field"]) if idx is not None else None
        return None

    def _apply_schema_msg(self, msg: dict, lenient: bool = False):
        """Apply one schema op locally.  lenient=True (log replay /
        legacy peer broadcast) makes it idempotent; otherwise the original
        call's strictness flags apply and errors propagate."""
        t = msg["type"]
        prev = getattr(self, "_from_broadcast", False)
        self._from_broadcast = True
        try:
            if t == "create_index":
                return self.create_index(
                    msg["name"], msg.get("options"),
                    if_not_exists=lenient or msg.get("ifNotExists", False))
            if t == "delete_index":
                if lenient and self.holder.index(msg["name"]) is None:
                    return None
                return self.delete_index(msg["name"])
            if t == "create_field":
                return self.create_field(
                    msg["index"], msg["field"], msg.get("options"),
                    if_not_exists=lenient or msg.get("ifNotExists", False))
            if t == "delete_field":
                idx = self.holder.index(msg["index"])
                if lenient and (idx is None
                                or idx.field(msg["field"]) is None):
                    return None
                return self.delete_field(msg["index"], msg["field"])
            if t == "create_view":
                return self.create_sql_view(
                    msg["name"], msg["sql"],
                    if_not_exists=lenient or msg.get("ifNotExists", False))
            if t == "delete_view":
                return self.delete_sql_view(msg["name"], if_exists=lenient)
            raise APIError(f"unknown schema op: {t}", 400)
        finally:
            self._from_broadcast = prev

    def handle_cluster_message(self, msg: dict):
        """Apply a peer's broadcast without re-broadcasting (reference:
        server.go:995 receiveMessage dispatch)."""
        t = msg.get("type")
        self._from_broadcast = True
        try:
            if t in ("create_index", "delete_index", "create_field",
                     "delete_field", "create_view", "delete_view"):
                # legacy direct broadcast (pre-log peers); idempotent apply
                self._apply_schema_msg(msg, lenient=True)
            elif t == "schema_propose":
                # we are the proposer's view of the leader
                self._from_broadcast = False
                try:
                    self._commit_schema_op(msg["op"])
                finally:
                    self._from_broadcast = True
            elif t == "recalculate_caches":
                self.recalculate_caches(broadcast=False)
            elif t == "schema_term":
                if not self.schema_log.accept_term(msg["term"],
                                                   msg["leader"]):
                    raise APIError(
                        f"stale term {msg['term']} "
                        f"(current {self.schema_log.term})", 409)
                self._log({"op": "schema_term", "term": msg["term"],
                           "leader": msg["leader"]})
            elif t == "schema_entry":
                entry = {"idx": msg["idx"], "term": msg.get("term", 0),
                         "op": msg["op"]}
                origin = msg.get("origin_uri")

                def fetch(frm):
                    if not origin:
                        return []
                    try:
                        resp = self.cluster.client._call(
                            origin, "GET",
                            f"/internal/schema/log?from={frm}")
                        return resp.get("entries", [])
                    except Exception:  # noqa: BLE001
                        return []
                for e in self.schema_log.receive(entry, fetch):
                    self._apply_schema_msg(e["op"], lenient=True)
                    self._log({"op": "schema_log", "idx": e["idx"],
                               "term": e.get("term", 0), "sop": e["op"]})
            elif t == "topology":
                if self.cluster is not None:
                    prev = self.cluster.apply_topology(
                        msg["nodes"], msg.get("replicas"),
                        version=msg.get("version"),
                        origin=msg.get("origin"))
                    if prev is not None:   # None = stale epoch, ignored
                        self._rebalance_after_topology(prev)
            else:
                raise APIError(f"unknown cluster message type: {t}", 400)
        finally:
            self._from_broadcast = False

    def cluster_join(self, node: dict) -> dict:
        """Admit a node into the running cluster and rebalance (reference
        analog: DAX RegisterWorker + directive push; the monolith reference
        has no resize).  Any member can process a join; the new topology is
        broadcast to all members including the joiner."""
        if self.cluster is None:
            raise APIError("node is not clustered", 400)
        if not node.get("id") or not node.get("uri"):
            raise APIError("join requires id and uri", 400)
        from featurebase_tpu_torch.cluster.cluster import ClusterQuorumError
        try:
            topo, prev = self.cluster.join_node(
                node, force=bool(node.get("force")))
        except ClusterQuorumError as e:
            raise APIError(str(e), 503)
        self._rebalance_after_topology(prev)
        return topo

    def cluster_remove(self, node_id: str, force: bool = False) -> dict:
        """Retire a node; remaining members pull the shards it owned from
        its replicas (or from the node itself if still reachable)."""
        if self.cluster is None:
            raise APIError("node is not clustered", 400)
        from featurebase_tpu_torch.cluster.cluster import ClusterQuorumError
        try:
            topo, prev = self.cluster.remove_node(node_id, force=force)
        except ValueError as e:
            raise APIError(str(e), 400)
        except ClusterQuorumError as e:
            raise APIError(str(e), 503)
        self._rebalance_after_topology(prev)
        return topo

    def _rebalance_after_topology(self, prev_snap):
        """Run rebalance_pull, surfacing (not swallowing) failure: log +
        metric + one immediate resync retry, so a failed pull doesn't leave
        an owner dataless until the next heartbeat cycle (reference
        discipline: metrics.go:7 stats on every recovery path)."""
        from featurebase_tpu_torch.utils.metrics import REGISTRY
        try:
            self.rebalance_pull(prev_snap)
        except Exception as ex:  # noqa: BLE001 — surfaced, then retried
            REGISTRY.count("rebalance_pull_errors")
            self.logger.error("rebalance pull after topology change "
                              "failed: %s; retrying via resync", ex)
            try:
                self.resync_shards()
            except Exception as ex2:  # noqa: BLE001
                REGISTRY.count("rebalance_resync_errors")
                self.logger.error("post-rebalance resync failed: %s "
                                  "(heartbeat resync will retry)", ex2)

    def rebalance_pull(self, prev_snap) -> int:
        """After a topology change, pull any shard this node now owns but
        has no data for from that shard's owners under the PREVIOUS
        topology (the DAX loadShard role, api_directive.go:559; periodic
        resync_shards then keeps replicas converged)."""
        if self.cluster is None or prev_snap is None:
            return 0
        pulled = 0
        snap = self.cluster.snapshot
        for index in list(self.holder.indexes):
            try:
                shards = self.cluster.all_shards(self, index)
            except Exception:  # noqa: BLE001
                continue
            for shard in shards:
                if not any(self.cluster.is_self(n)
                           for n in snap.shard_nodes(index, shard)):
                    continue
                if self.shard_fragment_checksums(index, shard)["fragments"]:
                    continue  # already holds data; resync reconciles drift
                prev_owners = prev_snap.shard_nodes(index, shard)
                for n in prev_owners:
                    if n.id == self.cluster.node_id or n.state == "DOWN":
                        continue
                    try:
                        data = self.cluster.client.shard_snapshot(
                            n.uri, index, shard)
                        self.restore_shard(index, shard, data)
                        pulled += 1
                        break
                    except Exception:  # noqa: BLE001
                        continue
        return pulled

    def replicate_index_keys(self, index: str, entries: Dict[str, int]):
        """Apply primary-assigned column-key entries (replication target)."""
        idx = self._index(index)
        entries = {k: int(v) for k, v in entries.items()}
        idx.translate_store.apply_entries(entries)
        self._log({"op": "keys", "i": index, "f": "", "entries": entries})

    def replicate_field_keys(self, index: str, field: str,
                             entries: Dict[str, int]):
        store = self._index(index).row_translation(field)
        if store is None:
            raise APIError("field does not use keys", 400)
        entries = {k: int(v) for k, v in entries.items()}
        store.apply_entries(entries)
        self._log({"op": "keys", "i": index, "f": field, "entries": entries})

    def translate_snapshot(self) -> dict:
        """Full translate-store state for a node joining/syncing (reference:
        /internal/translate/data stream, holder.go:1303 holderSyncer)."""
        out = {}
        for name in self.holder.indexes:
            idx = self.holder.index(name)
            fields = {}
            for fname in idx.fields:
                store = idx.row_translation(fname)
                if store is not None:
                    fields[fname] = store.to_json()
            out[name] = {"index": idx.translate_store.to_json(),
                         "fields": fields}
        if self.holder.sql_views:
            out["$views"] = dict(self.holder.sql_views)
        return out

    def apply_translate_snapshot(self, snap: dict):
        for name, d in (snap or {}).items():
            if name == "$views":
                self.holder.sql_views.update(d)
                continue
            idx = self.holder.index(name)
            if idx is None:
                continue
            for p, pd in (d.get("index") or {}).items():
                idx.translate_store.apply_entries(pd["keys"])
            for fname, fd in (d.get("fields") or {}).items():
                store = idx.row_translation(fname)
                if store is not None:
                    store.apply_entries(fd["keys"])

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
        if self._should_route_schema():
            return self._schema_op({"type": "create_index", "name": name,
                                    "options": options,
                                    "ifNotExists": if_not_exists})
        try:
            idx = self.holder.create_index(
                name, IndexOptions.from_json(options or {}),
                if_not_exists=if_not_exists)
        except ValueError as e:
            raise APIError(str(e), 409)
        self._log({"op": "create_index", "name": name, "options": options})
        self._broadcast({"type": "create_index", "name": name,
                         "options": options})
        return idx

    def delete_index(self, name: str):
        if self.holder.index(name) is None:
            raise APIError(f"index not found: {name}", 404)
        if self._should_route_schema():
            return self._schema_op({"type": "delete_index", "name": name})
        self.holder.delete_index(name)
        self._log({"op": "delete_index", "name": name})
        if self.cluster is not None:
            self.cluster.forget_index(name)
        self._broadcast({"type": "delete_index", "name": name})

    def create_field(self, index: str, field: str,
                     options: Optional[dict] = None,
                     if_not_exists: bool = False):
        idx = self._index(index)
        if self._should_route_schema():
            return self._schema_op({"type": "create_field", "index": index,
                                    "field": field, "options": options,
                                    "ifNotExists": if_not_exists})
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
        self._broadcast({"type": "create_field", "index": index,
                         "field": field, "options": options})
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
        if self._should_route_schema():
            return self._schema_op({"type": "delete_field", "index": index,
                                    "field": field})
        idx.delete_field(field)
        self._log({"op": "delete_field", "i": index, "f": field})
        self._broadcast({"type": "delete_field", "index": index,
                         "field": field})

    def create_sql_view(self, name: str, select_sql: str,
                        if_not_exists: bool = False):
        """Register a SQL view (reference: sql3 CREATE VIEW; kept on the
        holder, in snapshots and in the WAL, and sent to the peers)."""
        if self._should_route_schema():
            return self._schema_op({"type": "create_view", "name": name,
                                    "sql": select_sql,
                                    "ifNotExists": if_not_exists})
        if name in self.holder.sql_views and not if_not_exists:
            raise APIError(f"view already exists: {name}", 409)
        self.holder.sql_views[name] = select_sql
        self._log({"op": "create_view", "name": name, "sql": select_sql})
        self._broadcast({"type": "create_view", "name": name,
                         "sql": select_sql})

    def delete_sql_view(self, name: str, if_exists: bool = False):
        if name not in self.holder.sql_views:
            if if_exists:
                return
            raise APIError(f"view not found: {name}", 404)
        if self._should_route_schema():
            return self._schema_op({"type": "delete_view", "name": name})
        del self.holder.sql_views[name]
        self._log({"op": "delete_view", "name": name})
        self._broadcast({"type": "delete_view", "name": name})

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
        query_timeout.  Its root span ``query`` (utils/tracing.py) times
        it once, for query_seconds and the tracker's runtime."""
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
        node = self.cluster.node_id if self.cluster is not None else ""
        qid = self.tracker.start(index, qtext, node)
        REGISTRY.count("query_total", index=index)
        root = TRACER.start_query(qid, index=index)
        err: Optional[str] = None
        try:
            try:
                with TRACER.span("query.parse"):
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
                if profile:
                    root.profile()
                qctx = QueryContext(timeout=self.query_timeout,
                                    cancel_ev=self.tracker.cancel_event(qid))
                with qctx:
                    if self.max_query_memory:
                        self.executor.enforce_memory_limit(
                            index, parsed, shards, self.max_query_memory)
                    if self.distributed is not None:
                        # the coordinator: the nodes that apply the writes
                        # log them (query_remote_local)
                        results = self.distributed.execute(
                            index, parsed, shards=shards)
                    else:
                        self._log_write_calls(index, parsed)
                        results = self.executor.execute(
                            index, parsed, shards=shards)
            finally:
                root.finish()
                REGISTRY.observe("query_seconds", root.duration,
                                 index=index)
            out: Dict[str, Any] = {"results": results}
            if profile:
                out["profile"] = root.to_json()
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
            self.tracker.finish(qid, err, runtime=root.duration)

    def _log_write_calls(self, index: str, parsed):
        from featurebase_tpu_torch.pql.ast import WRITE_CALLS
        if self._logging() and any(
                c.name in WRITE_CALLS for c in parsed.calls):
            from featurebase_tpu_torch.cluster.wire import encode_query
            self._log({"op": "pql_ast", "i": index,
                       "q": encode_query(parsed)})

    def query_remote_local(self, index: str, query,
                           shards: Optional[List[int]]) -> List[Any]:
        """A coordinator-translated query over this node's shard subset:
        the raw partials (reference: the QueryRequest{Remote: true} leg,
        executor.go:6392); its writes are logged here."""
        self._log_write_calls(index, query)
        return self.executor.execute_remote(index, query, shards)

    def query_remote(self, index: str, ast: list,
                     shards: Optional[List[int]]) -> List[dict]:
        """The wire entry of POST /index/{i}/query with remote=true."""
        from featurebase_tpu_torch.cluster.wire import (decode_query,
                                                        encode_result)
        try:
            query = decode_query(ast)
            partials = self.query_remote_local(index, query, shards)
            return [encode_result(r) for r in partials]
        except ExecError as e:
            raise APIError(str(e), 400)

    # -- imports (reference api.go:1438 Import, 1771 ImportValue) ------------

    def import_bits(self, index: str, field: str, rows, cols,
                    timestamps=None, clear: bool = False,
                    row_keys=None, col_keys=None, forwarded: bool = False):
        """Set (or clear) bits; on a cluster node each shard's slice goes to
        every live owner (`forwarded` marks a slice a peer sent, applied
        here alone)."""
        if not forwarded:
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
        if self._scatters(forwarded):
            def body_for(sel):
                b = {"rowIDs": [int(r) for r in rows[sel]],
                     "columnIDs": [int(c) for c in cols[sel]],
                     "clear": clear}
                if timestamps is not None:
                    b["timestamps"] = list(np.asarray(timestamps)[sel])
                return b
            local = self._scatter_import(index, cols, body_for, field)
            rows, cols = rows[local], cols[local]
            if timestamps is not None:
                timestamps = list(np.asarray(timestamps)[local])
            if rows.size == 0:
                return
        if self._logging():
            self._log({"op": "bits", "i": index, "f": field,
                       "rows": rows.tolist(), "cols": cols.tolist(),
                       "ts": list(timestamps) if timestamps is not None
                       else None, "clear": clear})
        with idx.mutate_gate.shared():
            f.import_bits(rows, cols, timestamps=timestamps, clear=clear)
            if not clear:
                idx.mark_exists(cols)

    def _scatters(self, forwarded: bool) -> bool:
        """Whether an import goes to its shards' other owners: on a cluster
        node, unless a peer sent it or the WAL replays it (a replayed
        import was acknowledged where it was sent then; sending it again
        would undo the owners' later writes, as the JAX package's replay
        does)."""
        return self.cluster is not None and not forwarded \
            and not self._replaying

    def _scatter_import(self, index: str, cols, body_for, field: str):
        """Split an import by shard owner and forward each remote slice to
        every live replica (reference: internal_client.go:691 importNode a
        replica); returns the positions this node applies itself."""
        from featurebase_tpu_torch.cluster.client import NodeUnreachable
        from featurebase_tpu_torch.core.consts import SHARD_WIDTH
        snap = self.cluster.snapshot
        shards_arr = np.asarray(cols, dtype=np.int64) // SHARD_WIDTH
        self.cluster.note_shards(index, np.unique(shards_arr))
        local = np.zeros(len(shards_arr), dtype=bool)
        for shard in np.unique(shards_arr):
            sel = shards_arr == shard
            sent_any = False
            for node in snap.shard_nodes(index, int(shard)):
                if self.cluster.is_self(node):
                    local |= sel
                    sent_any = True
                elif node.state != "DOWN":
                    try:
                        self.cluster.client.forward_import(
                            node.uri, index, field, body_for(sel))
                        sent_any = True
                    except NodeUnreachable:
                        self.cluster.mark_down(node.id)
            if not sent_any:
                raise APIError(f"no live replica for shard {int(shard)}", 503)
        return np.nonzero(local)[0]

    def import_values(self, index: str, field: str, cols, values,
                      clear: bool = False, col_keys=None,
                      forwarded: bool = False):
        if not forwarded:
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
        if self._scatters(forwarded):
            values_arr = np.asarray(values)

            def body_for(sel):
                return {"columnIDs": [int(c) for c in cols[sel]],
                        "values": [v.item() if hasattr(v, "item") else v
                                   for v in values_arr[sel]],
                        "clear": clear}
            local = self._scatter_import(index, cols, body_for, field)
            cols, values = cols[local], list(values_arr[local])
            if cols.size == 0:
                return
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
        first as a ``roaring`` WAL entry.  On a cluster node the payload
        goes to every live owner of the shard (`forwarded` marks one a peer
        sent)."""
        from featurebase_tpu_torch.ingest.roaring_import import import_roaring
        from featurebase_tpu_torch.storage.wal import encode_bytes
        idx = self._index(index)
        if idx.field(field) is None:
            raise APIError(f"field not found: {field}", 404)
        if self._scatters(forwarded):
            if not self._forward_roaring(index, shard, {
                    f"{field}/{view}": {"data": data, "clear": clear}}):
                return
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
        reads neither and merges into the view as named).  On a cluster
        node the views go to every live owner of the shard, and each owner
        logs and replays them so."""
        from featurebase_tpu_torch.ingest.roaring_import import \
            import_roaring_shard
        from featurebase_tpu_torch.storage.wal import encode_bytes
        if self._scatters(forwarded):
            if not self._forward_roaring(index, shard, views):
                return
        idx = self._index(index)
        if self._logging():
            entries = []
            for spec, payload in views.items():
                fname = spec.split("/", 1)[0]
                vname = spec.split("/", 1)[1] if "/" in spec else "standard"
                if vname == "bsig":
                    vname = f"bsig_{fname}"
                entries.append({
                    "op": "roaring", "i": index, "f": fname, "shard": shard,
                    "data": encode_bytes(payload.get("data", b"")),
                    "view": vname, "clear": payload.get("clear", False),
                    "replace": bool(payload.get("replace", False))})
            self._log_all(entries)
        with idx.mutate_gate.shared():
            import_roaring_shard(idx, shard, views)

    def _forward_roaring(self, index: str, shard: int, views: dict) -> bool:
        """Send a shard's roaring views to its live remote owners; whether
        this node owns the shard too (and so applies them)."""
        import base64
        snap = self.cluster.snapshot
        owners = snap.shard_nodes(index, shard)
        self.cluster.note_shards(index, [shard])
        local = any(self.cluster.is_self(n) for n in owners)
        remote = [n for n in owners
                  if not self.cluster.is_self(n) and n.state != "DOWN"]
        if not local and not remote:
            raise APIError(f"no live replica for shard {shard}", 503)
        if remote:
            body = {"views": {
                spec: {"data": base64.b64encode(
                           p.get("data", b"")).decode("ascii"),
                       "clear": p.get("clear", False),
                       "replace": p.get("replace", False)}
                for spec, p in views.items()}}
            for node in remote:
                self.cluster.client.forward_roaring(node.uri, index, shard,
                                                    body)
        return local

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
        if self.cluster is not None:
            return self.cluster.route_create_index_keys(self, index, keys)
        entries = self._index(index).translate_store.create_keys(keys)
        self._log({"op": "keys", "i": index, "f": "", "entries": entries})
        return entries

    def primary_create_index_keys(self, index: str,
                                  keys: List[str]) -> Dict[str, int]:
        """The key partition primary's path: create here, log, replicate
        to the peers (reference: cluster.go:676 createIndexKeys)."""
        entries = self._index(index).translate_store.create_keys(keys)
        self._log({"op": "keys", "i": index, "f": "", "entries": entries})
        if self.cluster is not None:
            self.cluster.replicate_index_keys(index, entries)
        return entries

    def find_index_keys(self, index: str, keys: List[str]) -> Dict[str, int]:
        return self._index(index).translate_store.find_keys(keys)

    def create_field_keys(self, index: str, field: str,
                          keys: List[str]) -> Dict[str, int]:
        if self.cluster is not None:
            return self.cluster.route_create_field_keys(self, index, field,
                                                        keys)
        return self.primary_create_field_keys(index, field, keys)

    def primary_create_field_keys(self, index: str, field: str,
                                  keys: List[str]) -> Dict[str, int]:
        store = self._index(index).row_translation(field)
        if store is None:
            raise APIError("field does not use keys", 400)
        entries = store.create_keys(keys)
        self._log({"op": "keys", "i": index, "f": field, "entries": entries})
        if self.cluster is not None:
            self.cluster.replicate_field_keys(index, field, entries)
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
        the JAX package's over the same bits, and the counter is the
        fragments' writes (Fragment.writes_generation), comparable across
        nodes although each fragment's generations start at a base of its
        own."""
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
                total_gen += frag.writes_generation
        frags.sort(key=lambda d: (d["field"], d["view"]))
        return {"fragments": frags, "total_generation": total_gen}

    # -- shard snapshots and resync (reference: api.go:1265
    # IndexShardSnapshot, holder.go:1303 holderSyncer anti-entropy) --------

    def shard_snapshot_bytes(self, index: str, shard: int,
                             allow_proxy: bool = False) -> bytes:
        """One shard's fragments as a compressed npz bundle, in the JAX
        package's format (reference: api.go:1265 IndexShardSnapshot).  With
        allow_proxy (a client's backup) a node without the shard fetches
        the bundle from a live owner (reference: ctl/backup.go:342)."""
        import io
        idx = self._index(index)
        arrays = {}
        for f in idx.fields.values():
            for vname, v in f.views.items():
                frag = v.fragment(shard)
                if frag is None or frag.num_rows == 0:
                    continue
                d = frag.to_npz_dict()
                arrays[f"{f.name}|{vname}|rows"] = d["rows"]
                arrays[f"{f.name}|{vname}|words"] = d["words"]
        if not arrays and allow_proxy and self.cluster is not None:
            for n in self.cluster.snapshot.shard_nodes(index, shard):
                if self.cluster.is_self(n) or n.state == "DOWN":
                    continue
                try:
                    return self.cluster.client.shard_snapshot(
                        n.uri, index, shard)
                except Exception:  # noqa: BLE001 — the next owner
                    self.cluster.mark_down(n.id)
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        return buf.getvalue()

    def fragment_snapshot_bytes(self, index: str, shard: int, field: str,
                                view: str) -> bytes:
        """One fragment as npz: the unit anti-entropy transfers (reference:
        internal_client.go:1012 fragment data stream)."""
        import io
        idx = self._index(index)
        f = idx.field(field)
        v = f.view(view) if f is not None else None
        frag = v.fragment(shard) if v is not None else None
        buf = io.BytesIO()
        if frag is None or frag.num_rows == 0:
            np.savez_compressed(buf)
        else:
            d = frag.to_npz_dict()
            np.savez_compressed(buf, rows=d["rows"], words=d["words"])
        return buf.getvalue()

    @staticmethod
    def _restored(index: str, field, view: str, shard: int, rows, words,
                  old) -> None:
        """Install a fragment built from a bundle in place of `old` (None
        when absent): it carries old's generation + 2 (its own base + 2
        without one, as the JAX package's restore gives 2), so an
        optimistic reader that saw old's fails its check; the caller drops
        old's device copies."""
        from featurebase_tpu_torch.core.consts import BSI_OFFSET
        from featurebase_tpu_torch.model.fragment import Fragment
        from featurebase_tpu_torch.model.view import view_bsi_group
        frag = Fragment.from_npz_dict(index, field.name, view, shard,
                                      {"rows": rows, "words": words})
        frag.generation = (old.generation if old is not None
                           else frag.generation) + 2
        field.create_view_if_not_exists(view).fragments[shard] = frag
        if view == view_bsi_group(field.name) and len(rows):
            depth = int(max(int(r) for r in rows) - BSI_OFFSET + 1)
            field.bit_depth = max(field.bit_depth, depth, 1)

    @staticmethod
    def _drop_copies(frags) -> None:
        from featurebase_tpu_torch.executor.plan import drop_fragment_copies
        for fr in frags:
            fr.release_device()
        drop_fragment_copies({id(fr) for fr in frags})

    def restore_fragment(self, index: str, shard: int, field: str,
                         view: str, data: bytes):
        """Replace (or drop, when the bundle is empty) one fragment from a
        peer's snapshot, under the mutate gate."""
        import io
        idx = self._index(index)
        f = idx.field(field)
        if f is None:
            raise APIError(f"field not found: {field}", 404)
        z = np.load(io.BytesIO(data))
        with idx.mutate_gate.shared():
            v = f.create_view_if_not_exists(view)
            old = v.fragments.pop(shard, None)
            if "rows" in z.files and len(z["rows"]):
                self._restored(index, f, view, shard, z["rows"], z["words"],
                               old)
        if old is not None:
            self._drop_copies([old])
        if self.cluster is not None:
            self.cluster.note_shards(index, [shard])

    def restore_shard(self, index: str, shard: int, data: bytes,
                      forward: bool = False):
        """Replace one shard's fragments from a snapshot bundle (reference:
        http_handler.go:588 POST /internal/restore/{index}/{shard}).  With
        forward=True (a client's restore) the bundle also goes to every
        other live owner of the shard.  The swap runs under the index's
        mutate gate, shared as every writer's."""
        import io
        idx = self._index(index)
        owners = (self.cluster.snapshot.shard_nodes(index, shard)
                  if self.cluster is not None else [])
        if forward and self.cluster is not None:
            for n in owners:
                if self.cluster.is_self(n) or n.state == "DOWN":
                    continue
                try:
                    self.cluster.client.restore_shard(n.uri, index, shard,
                                                      data)
                except Exception:  # noqa: BLE001 — best effort
                    self.cluster.mark_down(n.id)
            if not any(self.cluster.is_self(n) for n in owners):
                return  # not an owner: fan-out only
        z = np.load(io.BytesIO(data))
        with idx.mutate_gate.shared():
            olds = {}
            for f in idx.fields.values():
                for vname, v in f.views.items():
                    old = v.fragments.pop(shard, None)
                    if old is not None:
                        olds[(f.name, vname)] = old
            for name in z.files:
                if not name.endswith("|rows"):
                    continue
                fname, vname, _ = name.split("|", 2)
                f = idx.field(fname)
                if f is None:
                    continue
                self._restored(index, f, vname, shard, z[name],
                               z[f"{fname}|{vname}|words"],
                               olds.get((fname, vname)))
        self._drop_copies(list(olds.values()))
        if self.cluster is not None:
            self.cluster.note_shards(index, [shard])

    def resync_shards(self) -> int:
        """Anti-entropy pass: for every shard this node owns, compare the
        fragment checksums with the other live owners and pull the
        diverging fragments from the most-written one (reference:
        holderSyncer holder.go:1303).  Every node runs it from its
        heartbeat, so whichever side is behind pulls.  Returns the shards
        pulled."""
        if self.cluster is None:
            return 0
        pulled = 0
        snap = self.cluster.snapshot
        for index in list(self.holder.indexes):
            try:
                shards = self.cluster.all_shards(self, index)
            except Exception:  # noqa: BLE001 — the next pass retries
                continue
            for shard in shards:
                owners = snap.shard_nodes(index, shard)
                if not any(self.cluster.is_self(n) for n in owners):
                    continue
                mine = self.shard_fragment_checksums(index, shard)
                my_key = [(d["field"], d["view"], d["checksum"])
                          for d in mine["fragments"]]
                best = None  # (total_gen, node, their_key)
                for n in owners:
                    if self.cluster.is_self(n) or n.state == "DOWN":
                        continue
                    try:
                        theirs = self.cluster.client.shard_checksums(
                            n.uri, index, shard)
                    except Exception:  # noqa: BLE001
                        self.cluster.mark_down(n.id)
                        continue
                    tk = [(d["field"], d["view"], d["checksum"])
                          for d in theirs["fragments"]]
                    if tk == my_key:
                        continue
                    tg = theirs["total_generation"]
                    if best is None or tg > best[0]:
                        best = (tg, n, tk)
                if best is None:
                    continue
                # pull only from a peer that has seen at least as many
                # writes (a peer behind pulls from this node on its pass)
                if best[0] >= mine["total_generation"]:
                    try:
                        self._pull_divergent_fragments(
                            index, shard, best[1], mine["fragments"],
                            best[2])
                        pulled += 1
                    except Exception:  # noqa: BLE001
                        self.cluster.mark_down(best[1].id)
        self.resync_translate()
        return pulled

    def _pull_divergent_fragments(self, index, shard, node, mine_frags,
                                  their_key):
        """Transfer only the fragments whose checksums differ, and drop the
        local fragments the peer does not have (reference: holder.go:1303
        syncs by checksum block)."""
        from featurebase_tpu_torch.utils.metrics import REGISTRY
        idx = self._index(index)
        my_map = {(d["field"], d["view"]): d["checksum"]
                  for d in mine_frags}
        their_map = {(f, v): ck for (f, v, ck) in their_key}
        nbytes = 0
        n_frags = 0
        for (field, view), ck in their_map.items():
            if my_map.get((field, view)) == ck:
                continue
            data = self.cluster.client.fragment_data(
                node.uri, index, shard, field, view)
            self.restore_fragment(index, shard, field, view, data)
            nbytes += len(data)
            n_frags += 1
        for (field, view) in set(my_map) - set(their_map):
            f = idx.field(field)
            v = f.view(view) if f is not None else None
            if v is not None:
                with idx.mutate_gate.shared():
                    old = v.fragments.pop(shard, None)
                if old is not None:
                    self._drop_copies([old])
        REGISTRY.count("resync_fragments_pulled", n_frags)
        REGISTRY.count("resync_bytes_pulled", nbytes)

    def translate_checksums(self) -> dict:
        """Key counts and content checksums of every translate store: the
        unit translate anti-entropy compares (reference: holderSyncer's
        translate sync, holder.go:1303)."""
        out = {}
        for name in self.holder.indexes:
            idx = self.holder.index(name)
            fields = {}
            for fname in idx.fields:
                store = idx.row_translation(fname)
                if store is not None:
                    fields[fname] = store.checksum()
            out[name] = {"index": idx.translate_store.checksum(),
                         "fields": fields}
        return out

    def resync_translate(self) -> int:
        """Merge the snapshot of every translate store where a live peer
        holds keys this node lacks (key -> id entries never change, so a
        merge converges)."""
        if self.cluster is None:
            return 0
        from featurebase_tpu_torch.utils.metrics import REGISTRY
        mine = self.translate_checksums()
        healed = 0
        for n in self.cluster.live_peers():
            try:
                theirs = self.cluster.client.translate_checksums(n.uri)
            except Exception:  # noqa: BLE001
                continue
            want = []
            for iname, td in theirs.items():
                md = mine.get(iname)
                if md is None:
                    continue
                if (td["index"] != md["index"]
                        and td["index"][0] >= md["index"][0]) or any(
                        td["fields"].get(fn) != md["fields"].get(fn)
                        and (td["fields"].get(fn) or [0, 0])[0]
                        >= (md["fields"].get(fn) or [0, 0])[0]
                        for fn in td.get("fields", {})):
                    want.append(iname)
            if not want:
                continue
            try:
                snap = self.cluster.client._call(
                    n.uri, "GET", "/internal/translate/snapshot")
            except Exception:  # noqa: BLE001
                continue
            self.apply_translate_snapshot(
                {k: v for k, v in snap.items() if k in want})
            healed += len(want)
            mine = self.translate_checksums()
            REGISTRY.count("resync_translate_stores", len(want))
        return healed

    def recalculate_caches(self, broadcast: bool = True):
        """Drop every field's TopN rank cache, so the next ranked query
        counts afresh, on every node of a cluster (reference:
        api.RecalculateCaches broadcast, fragment.go:2207)."""
        for idx in self.holder.indexes.values():
            for f in idx.fields.values():
                f._topn_cache.clear()
        if broadcast:
            self._broadcast({"type": "recalculate_caches"})

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
        and the shard width; on a cluster node the cluster's state, this
        node's id, the nodes and the replica count."""
        mesh = self.executor.mesh
        devs = mesh.members if mesh is not None else [self.executor.device]

        def name(dev) -> str:
            if dev.type == "cuda":
                import torch
                return f"{dev} {torch.cuda.get_device_name(dev)}"
            return str(dev)
        out = {"state": "NORMAL",
               "indexes": sorted(self.holder.indexes),
               "devices": [name(d) for d in devs],
               "shardWidth": 1 << 20}
        if self.cluster is not None:
            out["state"] = self.cluster.snapshot.state()
            out["nodeID"] = self.cluster.node_id
            out["nodes"] = [n.to_json() for n in self.cluster.nodes]
            out["replicas"] = self.cluster.snapshot.replicas
        return out
