"""DAX Controller: worker registry, job balancer, directive push, poller,
snapping turtle, and the cluster-wide key-translation service.

Own copy of featurebase_tpu/dax/controller.py, over the port's cluster
client and translate stores; its state persists in the same SQLite tables
(dax/sqldb.py), so that a controller directory written by either package
opens in the other's.

Mirrors the reference controller (reference: dax/controller/controller.go:30
— registers workers, Balancer assigns jobs per database,
balancer/balancer.go:63 AddWorker, :222 RemoveWorker, :285 balance;
poller/poller.go:14 health checks + deregistration; snapping_turtle.go:11
periodic snapshot loop; schemar/ schema registry).  Differences by design:
controller state is an in-memory registry persisted to SQLite (a legacy
controller.json is imported once), and key translation is centralized here
rather than spread over computer translate roles — one primary with
synchronous durability is the single-controller deployment's simplest
correct topology.  The controller is no data API: it serves only the
/dax/* routes and /health, through `Server(api=controller)`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from featurebase_tpu_torch.cluster.client import (InternalClient,
                                                  NodeUnreachable,
                                                  RemoteError)
from featurebase_tpu_torch.storage.translate import (FieldTranslateStore,
                                                     IndexTranslateStore)


class Directive:
    """Desired state for one computer (reference: dax/directive.go:8)."""

    def __init__(self, worker_id: str, version: int, schema: list,
                 shards: Dict[str, List[int]], views: dict):
        self.worker_id = worker_id
        self.version = version
        self.schema = schema
        self.shards = shards  # table -> sorted shard list
        self.views = views    # sql views

    def to_json(self) -> dict:
        return {"workerID": self.worker_id, "version": self.version,
                "schema": self.schema, "shards": self.shards,
                "views": self.views}


class Controller:
    def __init__(self, data_dir: Optional[str] = None,
                 client: Optional[InternalClient] = None):
        self.client = client or InternalClient(timeout=10.0)
        self._lock = threading.RLock()
        self.workers: Dict[str, dict] = {}      # id -> {uri, state}
        # table -> shard -> worker id, or None while the job is PENDING
        # (its database's min-workers requirement is unsatisfied;
        # reference: balancer jobs wait for WorkersMin, balancer.go:63)
        self.assignments: Dict[str, Dict[int, Optional[str]]] = {}
        # database registry (reference: dax databases with options incl.
        # workers-min; tables belong to a database)
        self.databases: Dict[str, dict] = {"default": {"min_workers": 0}}
        self.table_dbs: Dict[str, str] = {}
        self.schema: list = []
        self.views: Dict[str, str] = {}
        self.directive_version = 0
        self.data_dir = data_dir
        # key translation (see module docstring)
        self.index_keys: Dict[str, IndexTranslateStore] = {}
        self.field_keys: Dict[str, FieldTranslateStore] = {}
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._db = None
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            from featurebase_tpu_torch.dax.sqldb import ControllerDB
            self._db = ControllerDB(os.path.join(data_dir,
                                                 "controller.sqlite"))
            self._load_state()

    # -- persistence (reference: dax/controller/sqldb — SQL-backed state
    # with migrations; every save is one transaction) ----------------------

    def _state_path(self) -> str:
        return os.path.join(self.data_dir, "controller.json")

    def _state_dict(self) -> dict:
        return {
            "assignments": {t: {str(s): w for s, w in m.items()}
                            for t, m in self.assignments.items()},
            "databases": self.databases,
            "tableDbs": self.table_dbs,
            "schema": self.schema,
            "views": self.views,
            "version": self.directive_version,
            "indexKeys": {t: st.to_json()
                          for t, st in self.index_keys.items()},
            "fieldKeys": {k: st.to_json()
                          for k, st in self.field_keys.items()},
        }

    def _persist(self):
        if self._db is None:
            return
        self._db.save_state(self._state_dict())

    def _load_state(self):
        st = self._db.load_state() if self._db is not None else None
        if st is None:
            # import a pre-sqldb JSON blob once (older deployments)
            path = self._state_path()
            if not os.path.exists(path):
                return
            with open(path) as fh:
                st = json.load(fh)
            self._apply_state(st)
            self._persist()
            os.replace(path, path + ".imported")
            return
        self._apply_state(st)

    def _apply_state(self, st: dict):
        self.assignments = {t: {int(s): w for s, w in m.items()}
                            for t, m in st.get("assignments", {}).items()}
        self.databases = st.get("databases", {"default": {"min_workers": 0}})
        self.table_dbs = st.get("tableDbs", {})
        self.schema = st.get("schema", [])
        self.views = st.get("views", {})
        self.directive_version = st.get("version", 0)
        for t, d in st.get("indexKeys", {}).items():
            self.index_keys[t] = IndexTranslateStore.from_json(t, d)
        for k, d in st.get("fieldKeys", {}).items():
            t, f = k.split("/", 1)
            self.field_keys[k] = FieldTranslateStore.from_json(t, f, d)

    # -- worker registry (reference: controller.go RegisterNode) ----------------

    def register_worker(self, worker_id: str, uri: str) -> dict:
        with self._lock:
            self.workers[worker_id] = {"uri": uri.rstrip("/"),
                                       "state": "UP",
                                       "seen": time.time()}
            self._rebalance_locked()
        self._push_directives()
        return {"registered": worker_id}

    def deregister_worker(self, worker_id: str):
        with self._lock:
            self.workers.pop(worker_id, None)
            self._rebalance_locked()
        self._push_directives()

    def live_workers(self) -> List[str]:
        with self._lock:
            return sorted(w for w, m in self.workers.items()
                          if m["state"] == "UP")

    # -- databases (reference: dax databases w/ workers-min option) -------------

    def create_database(self, name: str, options: Optional[dict] = None):
        with self._lock:
            opts = options or {}
            self.databases[name] = {
                "min_workers": int(opts.get("minWorkers",
                                            opts.get("min_workers", 0)))}
            self._rebalance_locked()
        self._push_directives()

    def set_table_database(self, table: str, database: str):
        with self._lock:
            self.table_dbs[table] = database
            self.databases.setdefault(database, {"min_workers": 0})
            self._rebalance_locked()
        self._push_directives()

    def db_of(self, table: str) -> str:
        db = self.table_dbs.get(table)
        if db:
            return db
        for entry in self.schema:
            if entry.get("name") == table:
                db = (entry.get("options") or {}).get("database")
                if db:
                    return db
        return "default"

    def _db_satisfied(self, table: str, live: List[str]) -> bool:
        opts = self.databases.get(self.db_of(table), {})
        return len(live) >= int(opts.get("min_workers", 0)) and bool(live)

    # -- balancing (reference: balancer/balancer.go:285 balance) ----------------

    def _rebalance_locked(self):
        """Even spread with minimal movement per database: keep valid
        assignments, move orphaned/excess shards to the least-loaded live
        workers; tables whose database lacks its min-workers quota have
        every job parked as PENDING (worker None) until enough workers
        register (reference: balancer.go:63 WorkersMin gating)."""
        live = sorted(w for w, m in self.workers.items()
                      if m["state"] == "UP")
        loads = {w: 0 for w in live}
        orphans: List[tuple] = []
        for table, m in self.assignments.items():
            ok = self._db_satisfied(table, live)
            for shard, wid in list(m.items()):
                if not ok:
                    m[shard] = None
                    continue
                if wid in loads:
                    loads[wid] += 1
                else:
                    orphans.append((table, shard))
                    m[shard] = None
        if live:
            # cap per worker for even spread
            total = sum(loads.values()) + len(orphans)
            cap = -(-total // len(live))
            for table, m in self.assignments.items():
                for shard, wid in list(m.items()):
                    if wid in loads and loads[wid] > cap:
                        loads[wid] -= 1
                        orphans.append((table, shard))
                        m[shard] = None
            for table, shard in orphans:
                if not self._db_satisfied(table, live):
                    continue
                wid = min(loads, key=lambda w: (loads[w], w))
                self.assignments.setdefault(table, {})[shard] = wid
                loads[wid] += 1
        self.directive_version += 1
        self._persist()

    def assign_shard(self, table: str, shard: int) -> Optional[str]:
        """Idempotent shard registration; returns the owning worker id, or
        None while the job is pending (no workers / min-workers unmet)."""
        with self._lock:
            m = self.assignments.setdefault(table, {})
            wid = m.get(shard)
            if wid is not None and \
                    self.workers.get(wid, {}).get("state") == "UP":
                return wid
            live = self.live_workers()
            if not self._db_satisfied(table, live):
                m[shard] = None  # pending: assigned on next rebalance
                self._persist()
                return None
            loads = {w: 0 for w in live}
            for mm in self.assignments.values():
                for w in mm.values():
                    if w in loads:
                        loads[w] += 1
            wid = min(loads, key=lambda w: (loads[w], w))
            m[shard] = wid
            self.directive_version += 1
            self._persist()
        self._push_directive_to(wid)
        return wid

    def pending_jobs(self) -> Dict[str, List[int]]:
        with self._lock:
            return {t: sorted(s for s, w in m.items() if w is None)
                    for t, m in self.assignments.items()
                    if any(w is None for w in m.values())}

    def topology(self) -> dict:
        with self._lock:
            return {
                "version": self.directive_version,
                "workers": {w: m["uri"] for w, m in self.workers.items()
                            if m["state"] == "UP"},
                "assignments": {t: {str(s): w for s, w in m.items()
                                    if w is not None}
                                for t, m in self.assignments.items()},
            }

    # -- directives (reference: Director pushes ApplyDirective) ------------------

    def _directive_for(self, worker_id: str) -> Directive:
        shards = {}
        for table, m in self.assignments.items():
            mine = sorted(s for s, w in m.items() if w == worker_id)
            if mine:
                shards[table] = mine
        return Directive(worker_id, self.directive_version, self.schema,
                         shards, self.views)

    def _push_directive_to(self, worker_id: str):
        with self._lock:
            w = self.workers.get(worker_id)
            d = self._directive_for(worker_id).to_json()
        if w is None:
            return
        try:
            self.client._call(w["uri"], "POST", "/dax/directive", d)
        except (NodeUnreachable, RemoteError):
            with self._lock:
                w["state"] = "DOWN"

    def _push_directives(self):
        for wid in list(self.workers):
            self._push_directive_to(wid)

    # -- schema (reference: schemar/) ---------------------------------------------

    def apply_schema_op(self, msg: dict):
        """Schema change from a queryer; recorded and fanned out via
        directives."""
        with self._lock:
            t = msg.get("type")
            if t == "set_schema":
                self.schema = msg["schema"]
            elif t == "create_view":
                self.views[msg["name"]] = msg["sql"]
            elif t == "delete_view":
                self.views.pop(msg["name"], None)
            self.directive_version += 1
            self._persist()
        self._push_directives()

    # -- key translation ------------------------------------------------------------

    def translate(self, table: str, op: str, keys=None, ids=None,
                  field: str = "") -> dict:
        if field:
            k = f"{table}/{field}"
            store = self.field_keys.get(k)
            if store is None:
                store = self.field_keys[k] = FieldTranslateStore(table, field)
        else:
            store = self.index_keys.get(table)
            if store is None:
                store = self.index_keys[table] = IndexTranslateStore(table)
        if op == "create":
            out = store.create_keys(keys or [])
            self._persist()
            return out
        if op == "find":
            return store.find_keys(keys or [])
        if op == "ids":
            return {"keys": store.translate_ids(ids or [])}
        raise ValueError(op)

    # -- poller (reference: poller/poller.go:14) --------------------------------------

    def start_poller(self, interval: float = 2.0):
        def loop():
            while not self._stop.is_set():
                dead = []
                with self._lock:
                    workers = list(self.workers.items())
                for wid, m in workers:
                    ok = self.client.health(m["uri"])
                    with self._lock:
                        w = self.workers.get(wid)
                        if w is None:
                            continue
                        if ok:
                            w["state"] = "UP"
                            w["seen"] = time.time()
                        elif w["state"] == "UP":
                            w["state"] = "DOWN"
                            dead.append(wid)
                if dead:
                    with self._lock:
                        self._rebalance_locked()
                    self._push_directives()
                self._stop.wait(interval)
        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._threads.append(t)

    # -- snapping turtle (reference: snapping_turtle.go:11) -----------------------------

    def start_snapping_turtle(self, interval: float = 30.0):
        def loop():
            while not self._stop.is_set():
                self._stop.wait(interval)
                if self._stop.is_set():
                    return
                with self._lock:
                    workers = [(w, m["uri"]) for w, m in self.workers.items()
                               if m["state"] == "UP"]
                for wid, uri in workers:
                    try:
                        self.client._call(uri, "POST", "/dax/snapshot", {})
                    except (NodeUnreachable, RemoteError):
                        pass
        t = threading.Thread(target=loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self):
        self._stop.set()

    # -- HTTP surface (mounted on server.Server via extra_route) -----------------------

    def extra_route(self, h, method: str, path: str, query: dict) -> bool:
        import re
        if path == "/dax/register" and method == "POST":
            b = h._json()
            h._send(self.register_worker(b["id"], b["uri"]))
            return True
        if path == "/dax/deregister" and method == "POST":
            self.deregister_worker(h._json().get("id", ""))
            h._send({})
            return True
        if path == "/dax/topology" and method == "GET":
            h._send(self.topology())
            return True
        if path == "/dax/assign-shard" and method == "POST":
            b = h._json()
            wid = self.assign_shard(b["table"], int(b["shard"]))
            if wid is None:
                h._err("no live workers", 503)
                return True
            with self._lock:
                h._send({"worker": wid,
                         "uri": self.workers[wid]["uri"]})
            return True
        if path == "/dax/schema" and method == "POST":
            self.apply_schema_op(h._json())
            h._send({})
            return True
        if path == "/dax/schema" and method == "GET":
            with self._lock:
                h._send({"schema": self.schema, "views": self.views})
            return True
        if path == "/dax/database" and method == "POST":
            b = h._json()
            self.create_database(b["name"], b.get("options"))
            h._send({})
            return True
        if path == "/dax/databases" and method == "GET":
            with self._lock:
                h._send({"databases": self.databases,
                         "tables": self.table_dbs,
                         "pending": {t: s for t, s in
                                     self.pending_jobs().items()}})
            return True
        if path == "/dax/table-database" and method == "POST":
            b = h._json()
            self.set_table_database(b["table"], b["database"])
            h._send({})
            return True
        m = re.fullmatch(r"/dax/translate/([^/]+)(?:/([^/]+))?/(create|find|ids)",
                         path)
        if m and method == "POST":
            b = h._json()
            out = self.translate(m.group(1), m.group(3),
                                 keys=b.get("keys"), ids=b.get("ids"),
                                 field=m.group(2) or "")
            h._send(out)
            return True
        if path == "/health" and method == "GET":
            h._send({})
            return True
        return False

    # server.Server compatibility shims (the controller is not a data API)
    auth_token = None
