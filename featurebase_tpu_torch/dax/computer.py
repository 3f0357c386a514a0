"""DAX Computer: a data node driven by controller directives.

Own copy of featurebase_tpu/dax/computer.py: an API on its own device (the
card unless `device="cpu"`), whose queries run the port's kernels over the
shards the controller assigns it.

Mirrors the reference computer (reference: api_directive.go:19
ApplyDirective — diffs old/new directive, loads/unloads shards from
Writelogger+Snapshotter, :559 loadShard; computers log every write to the
Writelogger before ack, dax/computer/).  The computer holds no private
durable state: everything lives in the shared writelogger/snapshotter
directories, so any computer can take over any shard.

Where the JAX computer does not keep that promise, this one does: the
port's API builds a write's log entry only while `_logging()` holds, which
here is always, outside a replay; a PQL write (`pql_ast`) and a roaring
shard import are logged with no local WAL (the JAX API logs them only with
one, so the JAX computer acknowledges them and loses them on a restart);
roaring entries carry "replace" and the view's resolved name, and replay
as acknowledged; a shard's dataframe rows are logged too, and carried past
each snapshot; and a shard the computer gives up releases its device
copies.

A write's log entry and its apply are one step that neither a snapshot
nor a shard's load falls between (the computer's write gate), and a
computer logs a shard's write only while it holds the shard in the
resource manager (claimed before its load reads the log), so that no
acknowledged write misses both the snapshot and the log it replaces.
"""
from __future__ import annotations

import base64
import json
import threading
from contextlib import contextmanager
from typing import Dict, Set, Tuple

import numpy as np

from featurebase_tpu_torch.cluster.client import InternalClient
from featurebase_tpu_torch.cluster.wire import decode_query
from featurebase_tpu_torch.core.consts import SHARD_WIDTH
from featurebase_tpu_torch.dax.storage import NotHeld, ResourceManager
from featurebase_tpu_torch.dax.translate import install_remote_translation
from featurebase_tpu_torch.pql.ast import WRITE_CALLS
from featurebase_tpu_torch.server.api import API, APIError
from featurebase_tpu_torch.utils.rwlock import ShardedGate


def _shard_key(shard: int) -> str:
    return f"shard/{shard}"


class DaxComputerAPI(API):
    """API in compute mode (reference: OptServerIsComputeNode
    server.go:456)."""

    def __init__(self, worker_id: str, controller_uri: str,
                 resources: ResourceManager, **kw):
        # before API.__init__, which replays a local WAL (if one is
        # configured) through the write entry points
        self._replay = threading.local()   # .on: this thread replays
        self._write_gate = ShardedGate()
        super().__init__(**kw)
        self.worker_id = worker_id
        self.controller_uri = controller_uri.rstrip("/")
        self.resources = resources
        self.owned: Set[Tuple[str, int]] = set()
        self.dirty: Set[Tuple[str, int]] = set()
        self._dirty_lock = threading.Lock()
        self.directive_version = -1
        self._dax_lock = threading.RLock()
        self.dax_client = InternalClient(timeout=15.0)

    # -- write logging (reference: computers append to the Writelogger before
    # ack, dax/computer/interfaces.go WritelogService) ------------------------

    def _replaying_here(self) -> bool:
        return getattr(self._replay, "on", False)

    def _logging(self) -> bool:
        return not self._replaying and not self._replaying_here()

    @contextmanager
    def _writing(self):
        """A write, from its log entry to its apply: the write gate's
        shared side (a replay runs under the exclusive side, and takes
        nothing)."""
        if self._replaying_here():
            yield
            return
        with self._write_gate.shared():
            yield

    def _log(self, entry: dict):
        self._log_all([entry])

    def _log_all(self, entries):
        """Each entry split by shard to its shard's log, a shard's entries
        of one write in one append (one fsync); then to the local WAL, if
        one is configured (usually not).  A write to a shard this computer
        does not hold is refused (409) before anything is logged: a stale
        route reached it, and the queryer's next topology has the
        holder."""
        if not self._logging():
            return
        by_shard: Dict[Tuple[str, int], list] = {}
        for entry in entries:
            index = entry.get("i") or entry.get("name", "")
            for shard, sub in self._split_entry(index, entry):
                by_shard.setdefault((index, shard), []).append(sub)
        try:
            for index, shard in by_shard:
                if not self.resources.holds(index, _shard_key(shard),
                                            self.worker_id):
                    raise NotHeld(f"{index}/{_shard_key(shard)} is not held "
                                  f"by {self.worker_id}")
            for (index, shard), subs in by_shard.items():
                self.resources.append_many(index, _shard_key(shard), subs,
                                           holder=self.worker_id)
        except NotHeld as e:
            raise APIError(f"{e}: the shard moved; ask again", 409)
        with self._dirty_lock:
            self.dirty.update(by_shard)
        if self.wal is not None:
            for entry in entries:
                self.wal.append(entry)

    # every write entry point, from its log entry to its apply, under the
    # write gate (_writing)

    def query_full(self, *a, **kw):
        with self._writing():
            return super().query_full(*a, **kw)

    def query_remote_local(self, index: str, query, shards):
        if not any(c.name in WRITE_CALLS for c in query.calls):
            return super().query_remote_local(index, query, shards)
        with self._writing():
            return super().query_remote_local(index, query, shards)

    def import_bits(self, *a, **kw):
        with self._writing():
            return super().import_bits(*a, **kw)

    def import_values(self, *a, **kw):
        with self._writing():
            return super().import_values(*a, **kw)

    def import_roaring(self, *a, **kw):
        with self._writing():
            return super().import_roaring(*a, **kw)

    def import_roaring_shard(self, *a, **kw):
        with self._writing():
            return super().import_roaring_shard(*a, **kw)

    def dataframe_ingest(self, *a, **kw):
        with self._writing():
            return super().dataframe_ingest(*a, **kw)

    def _split_entry(self, index: str, entry: dict):
        """Split a write entry by shard so each shard resource's log replays
        independently; schema, translation and the schema log's entries
        are the controller's state and split into nothing."""
        op = entry["op"]
        if op in ("roaring", "dataframe"):
            yield entry["shard"], entry
            return
        if op in ("bits", "vals"):
            cols = np.asarray(entry["cols"], dtype=np.int64)
            shards = cols // SHARD_WIDTH
            for s in np.unique(shards):
                sel = np.nonzero(shards == s)[0]
                sub = dict(entry)
                sub["cols"] = cols[sel].tolist()
                if op == "bits":
                    sub["rows"] = [entry["rows"][i] for i in sel]
                    if entry.get("ts"):
                        sub["ts"] = [entry["ts"][i] for i in sel]
                else:
                    sub["values"] = [entry["values"][i] for i in sel]
                yield int(s), sub
            return
        if op == "pql_ast":
            cols = set()
            multi = False
            for call in decode_query(entry["q"]).calls:
                col = call.args.get("_col")
                if col is not None and not isinstance(col, str):
                    cols.add(int(col) // SHARD_WIDTH)
                else:
                    multi = True
            targets = cols if not multi else \
                {s for (i, s) in self.owned if i == index}
            for s in sorted(targets):
                yield s, entry

    # -- directives (reference: api_directive.go:19 ApplyDirective) --------------

    def apply_directive(self, d: dict):
        with self._dax_lock:
            if d.get("version", 0) < self.directive_version:
                return
            self.directive_version = d.get("version", 0)
            # schema first (additive + removals)
            schema = d.get("schema") or []
            self.holder.apply_schema(schema)
            want_idx = {s["name"] for s in schema}
            for name in list(self.holder.indexes):
                if name not in want_idx:
                    self.holder.delete_index(name)
            for s in schema:
                idx = self.holder.index(s["name"])
                want_fields = {f["name"] for f in s.get("fields", [])}
                for fname in list(idx.fields):
                    if fname not in want_fields and fname != "_exists":
                        idx.delete_field(fname)
            self.holder.sql_views = dict(d.get("views") or {})
            install_remote_translation(self, self.controller_uri,
                                       self.dax_client)
            # shard diff
            want: Set[Tuple[str, int]] = set()
            for table, shards in (d.get("shards") or {}).items():
                for s in shards:
                    want.add((table, int(s)))
            for table, shard in sorted(want - self.owned):
                self._load_shard(table, shard)
            for table, shard in sorted(self.owned - want):
                self._unload_shard(table, shard)
            self.owned = want

    def _load_shard(self, table: str, shard: int):
        """Snapshot + writelog replay (reference: api_directive.go:559
        loadShard): the shard claimed first, then read with this
        computer's writes held back (they apply after the replay)."""
        idx = self.holder.index(table)
        if idx is None:
            return
        with self._write_gate.exclusive():
            self._replay.on = True
            try:
                self.resources.load(
                    table, _shard_key(shard),
                    lambda blob: self._apply_shard_snapshot(table, shard,
                                                            blob),
                    lambda entry: self._replay_entry(table, shard, entry),
                    holder=self.worker_id)
            finally:
                self._replay.on = False

    def _unload_shard(self, table: str, shard: int):
        """Give the shard up (this computer's later writes to it are
        refused), then, once its writes in flight have applied, drop its
        fragments, their device mirrors and every stacked copy gathered
        from them, and its dataframe rows."""
        idx = self.holder.index(table)
        if idx is None:
            return
        self.resources.release(table, _shard_key(shard), self.worker_id)
        gone = []
        with self._write_gate.exclusive(), idx.mutate_gate.shared():
            for f in idx.fields.values():
                for v in f.views.values():
                    frag = v.fragments.pop(shard, None)
                    if frag is not None:
                        gone.append(frag)
            idx.dataframe.shards.pop(shard, None)
        self._drop_copies(gone)

    # -- shard snapshot blobs ---------------------------------------------------

    def _shard_snapshot_blob(self, table: str, shard: int) -> bytes:
        """All fragments of one shard as {field/view: b64 roaring}."""
        from featurebase_tpu_torch.ingest.roaring_import import export_roaring
        idx = self.holder.index(table)
        views: Dict[str, str] = {}
        for fname, f in idx.fields.items():
            for vname in list(f.views):
                data = export_roaring(idx, fname, shard, view=vname)
                if data:
                    views[f"{fname}/{vname}"] = \
                        base64.b64encode(data).decode("ascii")
        return json.dumps(views).encode()

    def _apply_shard_snapshot(self, table: str, shard: int, blob: bytes):
        from featurebase_tpu_torch.ingest.roaring_import import \
            import_roaring_shard
        idx = self.holder.index(table)
        views = {spec: {"data": base64.b64decode(b64), "replace": True}
                 for spec, b64 in json.loads(blob).items()}
        with idx.mutate_gate.shared():
            import_roaring_shard(idx, shard, views, suppress_existence=True)

    def _replay_entry(self, table: str, shard: int, entry: dict):
        """Apply one logged write restricted to this shard, as the API's WAL
        replay applies it (API._apply_wal_entry)."""
        from featurebase_tpu_torch.storage.wal import decode_bytes
        op = entry["op"]
        if op == "bits":
            self.import_bits(table, entry["f"], entry["rows"], entry["cols"],
                             timestamps=entry.get("ts"),
                             clear=entry.get("clear", False), forwarded=True)
        elif op == "vals":
            self.import_values(table, entry["f"], entry["cols"],
                               entry["values"],
                               clear=entry.get("clear", False),
                               forwarded=True)
        elif op == "roaring":
            from featurebase_tpu_torch.ingest.roaring_import import (
                import_roaring, import_roaring_shard)
            idx = self.holder.index(table)
            view = entry.get("view", "standard")
            data = decode_bytes(entry["data"])
            with idx.mutate_gate.shared():
                if entry.get("replace"):
                    import_roaring_shard(idx, entry["shard"], {
                        f"{entry['f']}/{view}": {
                            "data": data, "clear": entry.get("clear", False),
                            "replace": True}})
                else:
                    import_roaring(idx, entry["f"], entry["shard"], data,
                                   view=view,
                                   clear=entry.get("clear", False))
        elif op == "pql_ast":
            self.executor.execute_remote(table, decode_query(entry["q"]),
                                         [shard])
        elif op == "dataframe":
            df = self.holder.index(table).dataframe
            if "columns" in entry:
                df.ingest_json(entry["shard"], entry["columns"])
            else:
                df.ingest_parquet(entry["shard"],
                                  decode_bytes(entry["parquet"]))

    # -- snapshot loop target (reference: snapping turtle requests) ---------------

    def snapshot_dirty(self):
        """Snapshot each dirty shard this computer holds, its writes held
        back meanwhile: every write logged to the old log has applied
        before the blob is cut, and every later one goes to the new log.
        The blob holds the bitmaps alone (the JAX package's format): the
        shard's dataframe rows start the new log."""
        with self._dirty_lock:
            dirty = sorted(self.dirty)
            self.dirty.clear()
        for table, shard in dirty:
            idx = self.holder.index(table)
            if (table, shard) not in self.owned or idx is None:
                continue

            def rows(shard=shard):
                frame = idx.dataframe.shards.get(shard)
                return [] if frame is None else [{
                    "op": "dataframe", "i": table, "shard": shard,
                    "columns": {k: v.tolist()
                                for k, v in frame.columns.items()}}]
            with self._write_gate.exclusive():
                self.resources.snapshot(
                    table, _shard_key(shard),
                    lambda t=table, s=shard: self._shard_snapshot_blob(t, s),
                    holder=self.worker_id, carry=rows)

    # -- HTTP surface -------------------------------------------------------------

    def extra_route(self, h, method: str, path: str, query: dict) -> bool:
        if path == "/dax/directive" and method == "POST":
            self.apply_directive(h._json())
            h._send({})
            return True
        if path == "/dax/snapshot" and method == "POST":
            self.snapshot_dirty()
            h._send({})
            return True
        return False

    def register(self, self_uri: str):
        self.dax_client._call(self.controller_uri, "POST", "/dax/register",
                              {"id": self.worker_id, "uri": self_uri})
