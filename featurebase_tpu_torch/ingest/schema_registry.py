"""Confluent Schema Registry: REST client + in-process service stand-in.

The reference's kafka source resolves Avro schema ids through the
Confluent Schema Registry REST API (reference: idk/kafka/source.go —
confluent.SchemaRegistryClient; docker-compose ships the real service for
its integration tests, idk/docker-compose.yml).  Here:

- SchemaRegistryClient speaks the REST surface (GET /schemas/ids/{id},
  POST /subjects/{subject}/versions, GET /subjects,
  GET /subjects/{s}/versions/latest) with an id->schema cache, and is
  directly usable as the AvroDeserializer's registry lookup (callable).
- SchemaRegistryServer is the in-process stand-in serving the same
  routes (the docker-compose role for tests/dev rigs), with
  content-hash-deduplicated registration like the real service.

Own copy of featurebase_tpu/ingest/schema_registry.py.
"""
from __future__ import annotations

import json
import threading
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional


class SchemaRegistryError(Exception):
    pass


class SchemaRegistryClient:
    """REST client; instances are callable (schema_id -> parsed schema)
    so they plug straight into AvroDeserializer(registry=client)."""

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._cache: Dict[int, dict] = {}
        self._lock = threading.Lock()

    def _call(self, method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.url + path, data=data, method=method,
            headers={"Content-Type":
                     "application/vnd.schemaregistry.v1+json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("message", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise SchemaRegistryError(msg) from e
        except OSError as e:
            raise SchemaRegistryError(f"registry unreachable: {e}") from e

    def get_schema(self, schema_id: int) -> Optional[dict]:
        with self._lock:
            if schema_id in self._cache:
                return self._cache[schema_id]
        try:
            resp = self._call("GET", f"/schemas/ids/{schema_id}")
        except SchemaRegistryError:
            return None
        schema = json.loads(resp["schema"])
        with self._lock:
            self._cache[schema_id] = schema
        return schema

    __call__ = get_schema  # AvroDeserializer registry-lookup protocol

    def register(self, subject: str, schema: dict) -> int:
        resp = self._call("POST", f"/subjects/{subject}/versions",
                          {"schema": json.dumps(schema)})
        return int(resp["id"])

    def subjects(self) -> list:
        return self._call("GET", "/subjects")

    def latest(self, subject: str) -> dict:
        resp = self._call("GET", f"/subjects/{subject}/versions/latest")
        return {"id": int(resp["id"]),
                "version": int(resp["version"]),
                "schema": json.loads(resp["schema"])}


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.by_id: Dict[int, str] = {}
        self.id_by_content: Dict[str, int] = {}
        # subject -> [(version, id)]
        self.subjects: Dict[str, list] = {}
        self.next_id = 1


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass

    def _send(self, obj, status: int = 200):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type",
                         "application/vnd.schemaregistry.v1+json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        st: _State = self.server.state  # type: ignore[attr-defined]
        parts = self.path.strip("/").split("/")
        with st.lock:
            if parts[:2] == ["schemas", "ids"] and len(parts) == 3:
                sid = int(parts[2])
                if sid not in st.by_id:
                    return self._send(
                        {"error_code": 40403,
                         "message": "Schema not found"}, 404)
                return self._send({"schema": st.by_id[sid]})
            if parts == ["subjects"]:
                return self._send(sorted(st.subjects))
            if len(parts) == 4 and parts[0] == "subjects" \
                    and parts[2] == "versions":
                subj = parts[1]
                vers = st.subjects.get(subj)
                if not vers:
                    return self._send(
                        {"error_code": 40401,
                         "message": "Subject not found"}, 404)
                if parts[3] == "latest":
                    version, sid = vers[-1]
                else:
                    try:
                        version, sid = vers[int(parts[3]) - 1]
                    except (ValueError, IndexError):
                        return self._send(
                            {"error_code": 40402,
                             "message": "Version not found"}, 404)
                return self._send({"subject": subj, "version": version,
                                   "id": sid,
                                   "schema": st.by_id[sid]})
        self._send({"error_code": 404, "message": "not found"}, 404)

    def do_POST(self):
        st: _State = self.server.state  # type: ignore[attr-defined]
        parts = self.path.strip("/").split("/")
        n = int(self.headers.get("Content-Length") or 0)
        body = json.loads(self.rfile.read(n) or b"{}")
        if len(parts) == 3 and parts[0] == "subjects" \
                and parts[2] == "versions":
            subj = parts[1]
            schema_txt = body.get("schema", "")
            # canonical content key: same schema registers to the same id
            # (the real service's content dedup)
            key = json.dumps(json.loads(schema_txt), sort_keys=True)
            with st.lock:
                sid = st.id_by_content.get(key)
                if sid is None:
                    sid = st.next_id
                    st.next_id += 1
                    st.id_by_content[key] = sid
                    st.by_id[sid] = schema_txt
                vers = st.subjects.setdefault(subj, [])
                if not any(v_id == sid for _v, v_id in vers):
                    vers.append((len(vers) + 1, sid))
            return self._send({"id": sid})
        self._send({"error_code": 404, "message": "not found"}, 404)


class SchemaRegistryServer:
    """In-process registry service; start()/stop(); .url for clients."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        class _Srv(ThreadingHTTPServer):
            allow_reuse_address = True
            daemon_threads = True
        self.server = _Srv((host, port), _Handler)
        self.server.state = _State()
        self.host, self.port = self.server.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SchemaRegistryServer":
        t = threading.Thread(target=self.server.serve_forever, daemon=True)
        t.start()
        self._thread = t
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
