"""HTTP wire layer.

Own copy of featurebase_tpu/server/http_server.py over the port's API: the
same routes, statuses and JSON bodies, the cluster's internal routes
included (its messages, joins and leaves, the schema log, key replication,
shard snapshots and restore, resync, remote queries).  ``Server()``
without an API builds ``API()``, which runs on CUDA; pass
``API(device="cpu")`` to serve from the CPU.

Mirrors the reference's gorilla/mux route table (reference:
http_handler.go:493-589) on the Python stdlib ThreadingHTTPServer:

  POST   /index/{index}/query           PQL query (text or {"query": ...})
  POST   /index/{index}                 create index {"options": {...}}
  DELETE /index/{index}
  GET    /index[/{index}]               schema info
  POST   /index/{i}/field/{f}           create field {"options": {...}}
  DELETE /index/{i}/field/{f}
  GET    /schema                        full schema
  POST   /schema                        apply schema
  GET    /status                        cluster status
  GET    /shards?index=i                available shards
  POST   /index/{i}/field/{f}/import    JSON bulk import (rows/cols or
                                        cols/values; keys supported)
  POST   /internal/translate/index/{i}/keys/create   {"keys": [...]}
  POST   /internal/translate/index/{i}/keys/find
  POST   /internal/translate/field/{i}/{f}/keys/create
  POST   /internal/translate/field/{i}/{f}/keys/find
  GET    /metrics.json
  POST   /sql                           SQL query {"sql": ...}
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from featurebase_tpu_torch.server.api import API, APIError
from featurebase_tpu_torch.server.serialize import response_to_json


class Handler(BaseHTTPRequestHandler):
    api: API = None  # set by make_server
    protocol_version = "HTTP/1.1"

    # silence default logging
    def log_message(self, fmt, *args):
        pass

    # -- helpers ------------------------------------------------------------

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _json(self):
        # cached: the auth layer may peek at the body before routing, and
        # the socket can only be read once
        cached = getattr(self, "_json_cache", None)
        if cached is not None:
            return cached
        raw = self._body()
        if not raw:
            out = {}
        else:
            try:
                out = json.loads(raw)
            except json.JSONDecodeError:
                out = {"_raw": raw.decode("utf-8", "replace")}
        self._json_cache = out
        return out

    def _send(self, obj, status: int = 200):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _err(self, msg: str, status: int = 400):
        self._send({"error": msg}, status)

    def _send_text(self, text: str, status: int = 200):
        data = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    # -- routing ------------------------------------------------------------

    def do_GET(self):
        try:
            self._route("GET")
        except APIError as e:
            self._err(str(e), e.status)
        except Exception as e:  # noqa: BLE001
            # internal (non-user) error: captured by the error monitor
            # (reference: monitor.CaptureException, monitor/monitor.go:26)
            mon = getattr(self.api, "monitor", None)
            if mon is not None:
                mon.capture_exception(e, path=self.path,
                                      method=self.command)
            self._err(f"internal error: {e}", 500)

    do_POST = do_GET
    do_DELETE = do_GET

    def do_DELETE_(self):
        pass

    def _route(self, _):
        self._json_cache = None  # per-request (keep-alive reuses handlers)
        method = self.command
        path = self.path.split("?")[0].rstrip("/")
        query = {}
        if "?" in self.path:
            from urllib.parse import parse_qs
            query = {k: v[0] for k, v in
                     parse_qs(self.path.split("?", 1)[1]).items()}

        # service-specific routes (DAX controller/computer/queryer mount
        # extra endpoints on the same mux; reference: dax service_manager
        # shared mux, dax/service_manager.go:23)
        extra = getattr(self.api, "extra_route", None)
        if extra is not None and extra(self, method, path, query):
            return

        # authn/authz (reference: authn/authn.go OAuth middleware +
        # authz/authz.go per-index group grants; health/version stay open
        # like the reference's unauthenticated endpoints).  The static
        # auth_token is the cluster-internal credential == admin.
        token = getattr(self.api, "auth_token", None)
        auth = getattr(self.api, "auth", None)
        if (token or auth) and path not in ("/health", "/version"):
            got = self.headers.get("Authorization", "")
            if token and got == f"Bearer {token}":
                pass  # internal/static admin credential
            elif auth is not None:
                from featurebase_tpu_torch.server.auth import (AuthError,
                                                         route_access)
                body_txt = ""
                if path.endswith("/query") or path == "/sql":
                    b = self._json()  # cached; routing reuses it below
                    if isinstance(b, dict):
                        body_txt = str(b.get("query") or b.get("sql")
                                       or b.get("_raw") or "")
                idx, level = route_access(
                    method, path, pql=body_txt, sql=body_txt)
                try:
                    auth.check(got, idx, level)
                except AuthError as e:
                    return self._err(str(e), e.status)
            else:
                return self._err("unauthorized", 401)

        m = re.fullmatch(r"/index/([^/]+)/query", path)
        if m and method == "POST":
            body = self._json()
            if isinstance(body, dict) and body.get("remote"):
                # peer leg of distributed mapReduce (reference:
                # QueryRequest{Remote: true}, executor.go:6392 remoteExec)
                partials = self.api.query_remote(m.group(1),
                                                 body.get("ast") or [],
                                                 body.get("shards"))
                return self._send({"partials": partials})
            pql = body.get("query") or body.get("_raw") or ""
            shards = body.get("shards") if isinstance(body, dict) else None
            full = self.api.query_full(
                m.group(1), pql, shards=shards,
                transaction_id=self.headers.get("X-Featurebase-Transaction"))
            resp = response_to_json(full["results"])
            if "profile" in full:
                resp["profile"] = full["profile"]
            return self._send(resp)

        # -- observability (reference: /queries, /query-history
        # http_handler.go; tracker.go) ----------------------------------
        if path == "/queries" and method == "GET":
            return self._send({"queries": self.api.tracker.active()})
        m = re.fullmatch(r"/queries/(\d+)", path)
        if m and method == "DELETE":
            ok = self.api.tracker.cancel(int(m.group(1)))
            if not ok:
                raise APIError("no such active query", 404)
            return self._send({"canceled": True})
        if path == "/query-history" and method == "GET":
            return self._send({"queries": self.api.tracker.past()})
        if path == "/version" and method in ("GET", "POST"):
            # POST = diagnostics version check-in (the payload is the
            # anonymous usage body; reference verchk.go answers with the
            # latest release)
            from featurebase_tpu_torch import __version__
            return self._send({"version": __version__})
        if path == "/health" and method == "GET":
            return self._send({})
        if path == "/info" and method == "GET":
            import multiprocessing
            return self._send({"shardWidth": 1 << 20,
                               "cpuPhysicalCores": multiprocessing.cpu_count(),
                               "memory": _total_memory()})
        if path == "/metrics" and method == "GET":
            from featurebase_tpu_torch.utils.metrics import REGISTRY
            text = _prometheus_text(REGISTRY)
            data = text.encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        if path == "/internal/mem-usage" and method == "GET":
            return self._send({"totalUsed": _process_rss()})
        if path == "/internal/disk-usage" and method == "GET":
            import shutil as _sh
            d = self.api.data_dir or "."
            usage = _sh.disk_usage(d)
            return self._send({"usage": usage.used, "free": usage.free})

        # -- transactions (reference: api.go:2364 StartTransaction;
        # /transaction(s) routes) -----------------------------------------
        if path == "/transactions" and method == "GET":
            return self._send({"transactions": self.api.transactions.list()})
        m = re.fullmatch(r"/transaction(?:/([^/]+))?", path)
        if m and method == "POST":
            b = self._json()
            tid = m.group(1) or b.get("id") or ""
            if not tid:
                import uuid
                tid = str(uuid.uuid4())
            try:
                tx = self.api.transactions.start(
                    tid, float(b.get("timeout", 60)),
                    bool(b.get("exclusive", False)))
            except ValueError as e:
                return self._err(str(e), 409)
            return self._send({"transaction": tx.to_json()})
        m = re.fullmatch(r"/transaction/([^/]+)/finish", path)
        if m and method == "POST":
            try:
                tx = self.api.transactions.finish(m.group(1))
            except KeyError:
                return self._err("transaction not found", 404)
            return self._send({"transaction": tx.to_json()})
        m = re.fullmatch(r"/transaction/([^/]+)", path)
        if m and method == "GET":
            try:
                tx = self.api.transactions.get(m.group(1))
            except KeyError:
                return self._err("transaction not found", 404)
            return self._send({"transaction": tx.to_json()})

        m = re.fullmatch(r"/index/([^/]+)/field/([^/]+)/import", path)
        if m and method == "POST":
            b = self._json()
            fwd = self.headers.get("X-Featurebase-Forwarded") == "1"
            if "values" in b:
                self.api.import_values(
                    m.group(1), m.group(2),
                    cols=b.get("columnIDs", []), values=b["values"],
                    clear=b.get("clear", False),
                    col_keys=b.get("columnKeys"), forwarded=fwd)
            else:
                self.api.import_bits(
                    m.group(1), m.group(2),
                    rows=b.get("rowIDs", []), cols=b.get("columnIDs", []),
                    timestamps=b.get("timestamps"),
                    clear=b.get("clear", False),
                    row_keys=b.get("rowKeys"), col_keys=b.get("columnKeys"),
                    forwarded=fwd)
            return self._send({})

        m = re.fullmatch(r"/index/([^/]+)/field/([^/]+)", path)
        if m:
            if method == "POST":
                b = self._json()
                self.api.create_field(m.group(1), m.group(2),
                                      b.get("options", {}))
                return self._send({"success": True})
            if method == "DELETE":
                self.api.delete_field(m.group(1), m.group(2))
                return self._send({"success": True})

        m = re.fullmatch(r"/index/([^/]+)", path)
        if m:
            if method == "POST":
                b = self._json()
                self.api.create_index(m.group(1), b.get("options", {}))
                return self._send({"success": True})
            if method == "DELETE":
                self.api.delete_index(m.group(1))
                return self._send({"success": True})
            if method == "GET":
                idx = self.api.holder.index(m.group(1))
                if idx is None:
                    raise APIError("index not found", 404)
                return self._send(idx.to_info())

        if path == "/index" and method == "GET":
            return self._send(self.api.schema())

        if path == "/schema":
            if method == "GET":
                return self._send({"indexes": self.api.schema()})
            if method == "POST":
                b = self._json()
                self.api.apply_schema(b.get("indexes", []))
                return self._send({})

        if path == "/status" and method == "GET":
            return self._send(self.api.status())

        if path in ("/ui", "") and method == "GET":
            # built-in admin console (the lattice/ role)
            from featurebase_tpu_torch.server.console import CONSOLE_HTML
            data = CONSOLE_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return None

        if path == "/shards" and method == "GET":
            idx = query.get("index", "")
            if query.get("cluster") and self.api.cluster is not None:
                return self._send({"shards":
                                   self.api.cluster.all_shards(self.api, idx)})
            return self._send({"shards": self.api.available_shards(idx)})

        if path == "/metrics.json" and method == "GET":
            from featurebase_tpu_torch.storage.hostmem import hostmem
            from featurebase_tpu_torch.storage.residency import residency
            from featurebase_tpu_torch.utils.metrics import REGISTRY
            out = REGISTRY.to_json()
            out["hbm_residency"] = residency().stats()
            out["host_residency"] = hostmem().stats()
            return self._send(out)

        if path == "/sql" and method == "POST":
            b = self._json()
            sql = b.get("sql") or b.get("_raw") or ""
            from featurebase_tpu_torch.sql.engine import execute_sql
            return self._send(execute_sql(self.api, sql))

        m = re.fullmatch(r"/index/([^/]+)/import-atomic-record", path)
        if m and method == "POST":
            b = self._json()
            recs = b.get("records") or ([b] if b.get("col") is not None
                                        else [])
            self.api.import_atomic_record(m.group(1), recs)
            return self._send({"success": True})

        if path == "/sql-exec-graph" and method == "POST":
            # plan-operator tree without executing (reference:
            # http_handler.go:538 handlePostPlanSQL)
            b = self._json()
            from featurebase_tpu_torch.sql.planner import plan_graph
            return self._send(plan_graph(self.api,
                                         b.get("sql") or b.get("_raw") or ""))

        # roaring-payload imports (reference http_handler.go:520
        # /index/{i}/shard/{s}/import-roaring; api.go:618)
        m = re.fullmatch(r"/index/([^/]+)/field/([^/]+)/import-roaring/(\d+)",
                         path)
        if m and method == "POST":
            ct = self.headers.get("Content-Type", "")
            if "json" in ct:
                import base64
                b = self._json()
                data = base64.b64decode(b.get("data", ""))
                view = b.get("view", "standard")
                clear = b.get("clear", False)
            else:
                data = self._body()
                view = query.get("view", "standard")
                clear = query.get("clear", "false") == "true"
            fwd = self.headers.get("X-Featurebase-Forwarded") == "1"
            self.api.import_roaring(m.group(1), m.group(2), int(m.group(3)),
                                    data, view=view, clear=clear,
                                    forwarded=fwd)
            return self._send({})

        m = re.fullmatch(r"/index/([^/]+)/shard/(\d+)/import-roaring", path)
        if m and method == "POST":
            import base64
            b = self._json()
            views = {}
            for spec, p in (b.get("views") or {}).items():
                views[spec] = {"data": base64.b64decode(p.get("data", "")),
                               "clear": p.get("clear", False),
                               "replace": p.get("replace", False)}
            fwd = self.headers.get("X-Featurebase-Forwarded") == "1"
            self.api.import_roaring_shard(m.group(1), int(m.group(2)), views,
                                          forwarded=fwd)
            return self._send({})

        # dataframe ingest (reference: /index/{i}/dataframe/{shard},
        # http_handler.go:506; arrow.go ingest)
        m = re.fullmatch(r"/index/([^/]+)/dataframe/(\d+)", path)
        if m and method == "POST":
            ct = self.headers.get("Content-Type", "")
            if "json" in ct or not ct:
                b = self._json()
                self.api.dataframe_ingest(m.group(1), int(m.group(2)),
                                          columns=b.get("columns", b))
            else:
                self.api.dataframe_ingest(m.group(1), int(m.group(2)),
                                          parquet=self._body())
            return self._send({})

        if path == "/recalculate-caches" and method == "POST":
            # reference: http_handler.go:523 RecalculateCaches (admin)
            self.api.recalculate_caches()
            return self._send({})

        m = re.fullmatch(r"/export", path)
        if m and method == "GET":
            data = self.api.export_roaring(
                query.get("index", ""), query.get("field", ""),
                int(query.get("shard", 0)), query.get("view", "standard"))
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return

        # id allocation (reference http_handler.go /internal/idalloc)
        if path == "/internal/idalloc/data" and method == "GET":
            # full allocator state for backup (reference:
            # http_handler.go /internal/idalloc/data, ctl/backup.go)
            return self._send(self.api.idalloc.to_json())
        if path == "/internal/idalloc/restore" and method == "POST":
            self.api.idalloc.restore_json(self._json())
            return self._send({})
        if path == "/internal/idalloc/reserve" and method == "POST":
            b = self._json()
            ranges = self.api.reserve_ids(
                b.get("index", ""), b.get("key", ""), b.get("session", ""),
                int(b.get("offset", 0)), int(b.get("count", 0)))
            return self._send({"ranges": [r.to_json() for r in ranges]})
        if path == "/internal/idalloc/commit" and method == "POST":
            b = self._json()
            self.api.commit_ids(
                b.get("index", ""), b.get("key", ""), b.get("session", ""),
                int(b.get("offset", 0)), int(b.get("count", 0)))
            return self._send({})

        if path == "/internal/checkpoint" and method == "POST":
            self.api.checkpoint()
            return self._send({})

        m = re.fullmatch(r"/internal/translate/index/([^/]+)/keys/(create|find)",
                         path)
        if m and method == "POST":
            b = self._json()
            keys = b.get("keys", [])
            if m.group(2) == "create":
                return self._send(self.api.create_index_keys(m.group(1), keys))
            return self._send(self.api.find_index_keys(m.group(1), keys))

        m = re.fullmatch(
            r"/internal/translate/field/([^/]+)/([^/]+)/keys/(create|find)",
            path)
        if m and method == "POST":
            b = self._json()
            keys = b.get("keys", [])
            if m.group(3) == "create":
                return self._send(
                    self.api.create_field_keys(m.group(1), m.group(2), keys))
            return self._send(
                self.api.find_field_keys(m.group(1), m.group(2), keys))

        # -- cluster internal routes (reference: /internal/* table,
        # http_handler.go:557-589) --------------------------------------

        if path == "/internal/cluster/message" and method == "POST":
            self.api.handle_cluster_message(self._json())
            return self._send({})

        if path.startswith("/debug/pprof") and method == "GET":
            # live profiling (reference: Go pprof + fgprof endpoints,
            # http_handler.go:493-494; utils/profiling.py)
            from featurebase_tpu_torch.utils import profiling
            kind = path[len("/debug/pprof"):].strip("/")
            if kind in ("", "index"):
                return self._send({"profiles": [
                    "/debug/pprof/stacks",
                    "/debug/pprof/profile?seconds=1",
                    "/debug/pprof/heap"]})
            if kind == "stacks":
                return self._send_text(profiling.thread_stacks())
            if kind == "profile":
                secs = float(query.get("seconds", "1"))
                return self._send_text(profiling.cpu_profile(secs))
            if kind == "heap":
                return self._send_text(profiling.heap_profile())
            return self._err(f"unknown profile: {kind}", 404)

        if path == "/internal/fragments" and method == "GET":
            return self._send(
                {"fragments": self.api.fragments_info(query.get("index"))})

        if path == "/internal/errors" and method == "GET":
            # error-monitor ring (reference: Sentry events; monitor.go)
            return self._send(
                {"events": self.api.monitor.recent(
                    int(query.get("n", "50")))})

        if path == "/internal/diagnostics" and method == "GET":
            # anonymous usage payload + last version check-in
            # (reference: diagnostics.go:29, verchk.go)
            d = self.api.diagnostics
            return self._send({"payload": d.payload(),
                               "lastVersionCheck": d.last_version_check})

        if path == "/internal/schema/log" and method == "GET":
            # ordered schema-log suffix for follower catch-up
            # (cluster/schemalog.py; reference: etcd watch/get on /schema)
            frm = int(query.get("from", "0"))
            log = self.api.schema_log
            return self._send({"entries": log.suffix(frm),
                               "applied": log.applied,
                               "term": log.term})

        if path == "/internal/cluster/join" and method == "POST":
            return self._send(self.api.cluster_join(self._json()))

        if path == "/internal/cluster/leave" and method == "POST":
            return self._send(
                self.api.cluster_remove(self._json().get("id", ""),
                                        force=bool(
                                            self._json().get("force"))))

        m = re.fullmatch(r"/internal/translate/index/([^/]+)/replicate", path)
        if m and method == "POST":
            self.api.replicate_index_keys(m.group(1),
                                          self._json().get("entries", {}))
            return self._send({})

        m = re.fullmatch(r"/internal/translate/field/([^/]+)/([^/]+)/replicate",
                         path)
        if m and method == "POST":
            self.api.replicate_field_keys(m.group(1), m.group(2),
                                          self._json().get("entries", {}))
            return self._send({})

        m = re.fullmatch(r"/internal/translate/index/([^/]+)/ids", path)
        if m and method == "POST":
            idx = self.api.holder.index(m.group(1))
            if idx is None:
                raise APIError("index not found", 404)
            keys = idx.translate_store.translate_ids(
                self._json().get("ids", []))
            return self._send({"keys": keys})

        m = re.fullmatch(r"/internal/translate/field/([^/]+)/([^/]+)/ids",
                         path)
        if m and method == "POST":
            store = self.api.holder.index(m.group(1)).row_translation(
                m.group(2)) if self.api.holder.index(m.group(1)) else None
            if store is None:
                raise APIError("field not found or unkeyed", 404)
            return self._send(
                {"keys": store.translate_ids(self._json().get("ids", []))})

        if path == "/internal/translate/snapshot" and method == "GET":
            return self._send(self.api.translate_snapshot())

        if path == "/internal/translate/restore" and method == "POST":
            self.api.apply_translate_snapshot(self._json().get("snap", {}))
            return self._send({})

        # shard snapshot / restore / checksums (reference: api.go:1265
        # IndexShardSnapshot; http_handler.go:588 POST /internal/restore)
        m = re.fullmatch(r"/internal/index/([^/]+)/shard/(\d+)/fragments",
                         path)
        if m and method == "GET":
            return self._send(self.api.shard_fragment_checksums(
                m.group(1), int(m.group(2))))

        m = re.fullmatch(r"/internal/index/([^/]+)/shard/(\d+)/snapshot",
                         path)
        if m and method == "GET":
            proxy = self.headers.get("X-Featurebase-Forwarded") != "1"
            data = self.api.shard_snapshot_bytes(m.group(1), int(m.group(2)),
                                                 allow_proxy=proxy)
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return None

        m = re.fullmatch(r"/internal/index/([^/]+)/shard/(\d+)/fragment",
                         path)
        if m and method == "GET":
            data = self.api.fragment_snapshot_bytes(
                m.group(1), int(m.group(2)), query.get("field", ""),
                query.get("view", ""))
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return None

        m = re.fullmatch(r"/internal/restore/([^/]+)/(\d+)", path)
        if m and method == "POST":
            fwd = self.headers.get("X-Featurebase-Forwarded") != "1"
            self.api.restore_shard(m.group(1), int(m.group(2)), self._body(),
                                   forward=fwd)
            return self._send({})

        if path == "/internal/translate/checksums" and method == "GET":
            return self._send(self.api.translate_checksums())

        if path == "/internal/nodes" and method == "GET":
            # reference: /internal/nodes (http_handler.go)
            if self.api.cluster is not None:
                return self._send(
                    [n.to_json() for n in self.api.cluster.nodes])
            return self._send([{"id": "local", "uri": "",
                                "state": "STARTED", "isPrimary": True}])

        if path == "/internal/shards/max" and method == "GET":
            # reference: /internal/shards/max — max shard per index
            out = {}
            for name in self.api.holder.indexes:
                shards = self.api.available_shards(name)
                out[name] = max(shards) if shards else 0
            return self._send({"standard": out})

        m = re.fullmatch(r"/internal/index/([^/]+)/shards", path)
        if m and method == "GET":
            return self._send(
                {"shards": self.api.available_shards(m.group(1))})

        if path == "/internal/fragment/nodes" and method == "GET":
            # reference: /internal/fragment/nodes?index=&shard=
            idx = query.get("index", "")
            shard = int(query.get("shard", 0))
            if self.api.cluster is not None:
                nodes = self.api.cluster.snapshot.shard_nodes(idx, shard)
                return self._send([n.to_json() for n in nodes])
            return self._send([{"id": "local", "uri": "",
                                "state": "STARTED", "isPrimary": True}])

        if path == "/internal/partition/nodes" and method == "GET":
            part = int(query.get("partition", 0))
            if self.api.cluster is not None:
                nodes = self.api.cluster.snapshot.partition_nodes(part)
                return self._send([n.to_json() for n in nodes])
            return self._send([])

        m = re.fullmatch(
            r"/internal/index/([^/]+)/field/([^/]+)/mutex-check", path)
        if m and method == "GET":
            return self._send(self.api.mutex_check(
                m.group(1), m.group(2),
                limit=int(query.get("limit", 1000))))

        if path == "/internal/oauth-config" and method == "GET":
            # reference: /internal/oauth-config (authn); secrets excluded
            auth = getattr(self.api, "auth", None)
            if auth is None:
                return self._send({"enable": False})
            v = auth.verifier
            return self._send({"enable": True, "alg": v.alg,
                               "issuer": v.issuer,
                               "audience": v.audience,
                               "groupsClaim": v.groups_claim})

        if path == "/internal/resync" and method == "POST":
            return self._send({"pulled": self.api.resync_shards()})

        raise APIError(f"no route: {method} {path}", 404)


def _prometheus_text(registry) -> str:
    """Render the registry in Prometheus exposition format (reference:
    /metrics endpoint, metrics.go Prometheus counters)."""
    d = registry.to_json()
    lines = []
    for k, v in sorted(d["counters"].items()):
        lines.append(f"featurebase_{k} {v}")
    for k, v in sorted(d["gauges"].items()):
        lines.append(f"featurebase_{k} {v}")
    for k, h in sorted(d["histograms"].items()):
        base, _, labels = k.partition("{")
        lb = "{" + labels if labels else ""
        lines.append(f"featurebase_{base}_count{lb} {h['count']}")
        lines.append(f"featurebase_{base}_p50{lb} {h['p50']}")
        lines.append(f"featurebase_{base}_p99{lb} {h['p99']}")
    lines.append(f"featurebase_uptime_seconds {d['uptime']}")
    return "\n".join(lines) + "\n"


def _total_memory() -> int:
    try:
        import os
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 0


def _process_rss() -> int:
    try:
        with open("/proc/self/statm") as fh:
            import os
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class Server:
    """In-process HTTP server (reference: pilosa.Server server.go:46,
    minus etcd — single-controller for now)."""

    def __init__(self, api: Optional[API] = None, host: str = "127.0.0.1",
                 port: int = 0, defer_api: bool = False,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None):
        """With defer_api=True the listening socket is bound (so the port is
        known for cluster config) but the API is attached later via
        set_api() — used by the multi-node harness where node URIs must
        exist before each node's Cluster/API can be built.

        tls_cert/tls_key enable HTTPS (reference: server/config.go TLS
        section — certificate path + key path)."""
        self.api = api if defer_api else (api or API())
        self._handler_cls = type("BoundHandler", (Handler,),
                                 {"api": self.api})
        self.httpd = ThreadingHTTPServer((host, port), self._handler_cls)
        self.tls = bool(tls_cert)
        if tls_cert:
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def set_api(self, api: API):
        self.api = api
        self._handler_cls.api = api

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        scheme = "https" if getattr(self, "tls", False) else "http"
        return f"{scheme}://127.0.0.1:{self.port}"
