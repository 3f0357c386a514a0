"""Python client library.

Mirrors the reference's Go client (reference: client/ 8.4K LoC —
cluster-aware HTTP client with shard->node routing client.go /
shardnodes.go, ORM-ish query builders orm.go, batch importer importer.go).
Own copy of featurebase_tpu/client.py: it speaks HTTP only, so it talks
to a server of either package.

Usage:
    c = Client("http://127.0.0.1:10101")          # or Client([uri1, uri2])
    idx = c.index("events", keys=False)
    f = idx.field("kind", type="mutex")
    c.create_schema(idx)
    c.query(idx.count(f.row(3)))
    with c.batch(idx, ["kind", "score"]) as b:
        b.add(1, kind=3, score=10)
"""
from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Sequence, Union

SHARD_WIDTH = 1 << 20


class ClientError(Exception):
    def __init__(self, msg: str, status: int = 0):
        super().__init__(msg)
        self.status = status


# -- ORM query builders (reference: client/orm.go) -----------------------------


class PQL:
    """A composable PQL expression."""

    __slots__ = ("text",)

    def __init__(self, text: str):
        self.text = text

    def __str__(self):
        return self.text


def _arg(v) -> str:
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class FieldRef:
    def __init__(self, index: "IndexRef", name: str,
                 options: Optional[dict] = None):
        self.index = index
        self.name = name
        self.options = options or {}

    # row-level builders
    def row(self, value) -> PQL:
        return PQL(f"Row({self.name}={_arg(value)})")

    def set(self, column, value) -> PQL:
        return PQL(f"Set({_arg(column)}, {self.name}={_arg(value)})")

    def clear(self, column, value) -> PQL:
        return PQL(f"Clear({_arg(column)}, {self.name}={_arg(value)})")

    def topn(self, n: int, *filters: PQL) -> PQL:
        inner = "".join(f", {f}" for f in filters)
        return PQL(f"TopN({self.name}{inner}, n={n})")

    def rows(self, **kw) -> PQL:
        args = "".join(f", {k}={_arg(v)}" for k, v in kw.items())
        return PQL(f"Rows({self.name}{args})")

    def sum(self, filter: Optional[PQL] = None) -> PQL:
        inner = f"{filter}, " if filter else ""
        return PQL(f"Sum({inner}field={self.name})")

    def min(self, filter: Optional[PQL] = None) -> PQL:
        inner = f"{filter}, " if filter else ""
        return PQL(f"Min({inner}field={self.name})")

    def max(self, filter: Optional[PQL] = None) -> PQL:
        inner = f"{filter}, " if filter else ""
        return PQL(f"Max({inner}field={self.name})")

    def gt(self, v) -> PQL:
        return PQL(f"Row({self.name} > {_arg(v)})")

    def lt(self, v) -> PQL:
        return PQL(f"Row({self.name} < {_arg(v)})")

    def between(self, lo, hi) -> PQL:
        return PQL(f"Row({_arg(lo)} <= {self.name} <= {_arg(hi)})")


class IndexRef:
    def __init__(self, name: str, keys: bool = False,
                 options: Optional[dict] = None):
        self.name = name
        self.keys = keys
        self.options = options or {}
        self.fields: Dict[str, FieldRef] = {}

    def field(self, name: str, **options) -> FieldRef:
        f = self.fields.get(name)
        if f is None:
            f = self.fields[name] = FieldRef(self, name, options)
        return f

    # combinators
    @staticmethod
    def union(*rows: PQL) -> PQL:
        return PQL(f"Union({', '.join(map(str, rows))})")

    @staticmethod
    def intersect(*rows: PQL) -> PQL:
        return PQL(f"Intersect({', '.join(map(str, rows))})")

    @staticmethod
    def difference(*rows: PQL) -> PQL:
        return PQL(f"Difference({', '.join(map(str, rows))})")

    @staticmethod
    def xor(*rows: PQL) -> PQL:
        return PQL(f"Xor({', '.join(map(str, rows))})")

    @staticmethod
    def not_(row: PQL) -> PQL:
        return PQL(f"Not({row})")

    @staticmethod
    def count(row: PQL) -> PQL:
        return PQL(f"Count({row})")

    @staticmethod
    def all(limit: Optional[int] = None) -> PQL:
        return PQL("All()")

    def group_by(self, *rows_calls: PQL, **kw) -> PQL:
        args = "".join(f", {k}={v}" for k, v in kw.items())
        return PQL(f"GroupBy({', '.join(map(str, rows_calls))}{args})")


# -- client ---------------------------------------------------------------------


class Client:
    """Cluster-aware HTTP client (reference: client/client.go).

    Accepts one URI or a list; requests fail over across hosts, and the
    client refreshes /status node lists for shard-aware routing of imports
    (reference: shardnodes.go)."""

    def __init__(self, hosts: Union[str, Sequence[str]],
                 timeout: float = 60.0, auth_token: Optional[str] = None):
        self.hosts = [hosts] if isinstance(hosts, str) else list(hosts)
        self.hosts = [h.rstrip("/") for h in self.hosts]
        self.timeout = timeout
        self.auth_token = auth_token
        self._lock = threading.Lock()
        self._nodes: List[dict] = []

    # -- transport ---------------------------------------------------------------

    def _request(self, method: str, path: str, body=None, raw=None,
                 host: Optional[str] = None):
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        last_err: Optional[Exception] = None
        hosts = [host] if host else self.hosts
        for h in hosts:
            req = urllib.request.Request(h + path, data=data, method=method)
            req.add_header("Content-Type", "application/json")
            if self.auth_token:
                req.add_header("Authorization", f"Bearer {self.auth_token}")
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    payload = resp.read()
                return json.loads(payload) if payload else {}
            except urllib.error.HTTPError as e:
                try:
                    msg = json.loads(e.read()).get("error", str(e))
                except Exception:  # noqa: BLE001
                    msg = str(e)
                raise ClientError(msg, e.code) from e
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                last_err = e
                continue
        raise ClientError(f"no host reachable: {last_err}")

    # -- schema (reference: client.go SyncSchema) ----------------------------------

    def index(self, name: str, keys: bool = False, **options) -> IndexRef:
        return IndexRef(name, keys=keys, options=options)

    def create_schema(self, index: IndexRef):
        self._request("POST", f"/index/{index.name}",
                      {"options": {"keys": index.keys, **index.options}})
        for f in index.fields.values():
            self._request("POST", f"/index/{index.name}/field/{f.name}",
                          {"options": f.options})

    def create_index(self, name: str, options: Optional[dict] = None,
                     if_not_exists: bool = False):
        try:
            self._request("POST", f"/index/{name}",
                          {"options": options or {}})
        except ClientError as e:
            if not (if_not_exists and e.status == 409):
                raise

    def create_field(self, index: str, field: str,
                     options: Optional[dict] = None,
                     if_not_exists: bool = False):
        try:
            self._request("POST", f"/index/{index}/field/{field}",
                          {"options": options or {}})
        except ClientError as e:
            if not (if_not_exists and e.status == 409):
                raise

    def schema(self) -> list:
        return self._request("GET", "/schema").get("indexes", [])

    def delete_index(self, index: Union[str, IndexRef]):
        name = index if isinstance(index, str) else index.name
        self._request("DELETE", f"/index/{name}")

    def status(self) -> dict:
        return self._request("GET", "/status")

    # -- queries --------------------------------------------------------------------

    def query(self, index: Union[str, IndexRef], pql: Union[str, PQL],
              shards: Optional[List[int]] = None) -> list:
        name = index if isinstance(index, str) else index.name
        body: Dict[str, Any] = {"query": str(pql)}
        if shards is not None:
            body["shards"] = shards
        return self._request("POST", f"/index/{name}/query",
                             body)["results"]

    def sql(self, statement: str) -> dict:
        return self._request("POST", "/sql", {"sql": statement})

    # -- imports (reference: client/importer.go shard-batched imports) ----------------

    def import_bits(self, index: str, field: str, rows, cols,
                    clear: bool = False, row_keys=None, col_keys=None):
        body: Dict[str, Any] = {"clear": clear}
        if col_keys is not None:
            body["columnKeys"] = list(col_keys)
        else:
            body["columnIDs"] = [int(c) for c in cols]
        if row_keys is not None:
            body["rowKeys"] = list(row_keys)
        else:
            body["rowIDs"] = [int(r) for r in rows]
        self._request("POST", f"/index/{index}/field/{field}/import", body)

    def import_values(self, index: str, field: str, cols, values,
                      clear: bool = False, col_keys=None):
        body: Dict[str, Any] = {"values": list(values), "clear": clear}
        if col_keys is not None:
            body["columnKeys"] = list(col_keys)
        else:
            body["columnIDs"] = [int(c) for c in cols]
        self._request("POST", f"/index/{index}/field/{field}/import", body)

    def batch(self, index: Union[str, IndexRef], fields: List[str],
              size: int = 1 << 16) -> "ClientBatch":
        name = index if isinstance(index, str) else index.name
        return ClientBatch(self, name, fields, size)


class ClientBatch:
    """Record-oriented batch importer (reference: batch/batch.go:55
    RecordBatch + client importer).  Buffers records, splits per field into
    bit/value imports on flush."""

    def __init__(self, client: Client, index: str, fields: List[str],
                 size: int):
        self.client = client
        self.index = index
        self.fields = fields
        self.size = size
        self._records: List[tuple] = []
        self._field_types: Optional[Dict[str, dict]] = None

    def add(self, record_id, **values):
        self._records.append((record_id, values))
        if len(self._records) >= self.size:
            self.flush()

    def _types(self) -> Dict[str, dict]:
        if self._field_types is None:
            schema = self.client.schema()
            self._field_types = {}
            for idx in schema:
                if idx["name"] == self.index:
                    for f in idx["fields"]:
                        self._field_types[f["name"]] = f["options"]
        return self._field_types

    def flush(self):
        if not self._records:
            return
        types = self._types()
        per_field: Dict[str, dict] = {}
        for rid, values in self._records:
            for fname, v in values.items():
                if v is None:
                    continue
                opts = types.get(fname, {})
                b = per_field.setdefault(fname, {"rows": [], "cols": [],
                                                 "values": []})
                if opts.get("type") in ("int", "decimal", "timestamp"):
                    b["cols"].append(rid)
                    b["values"].append(v)
                else:
                    vs = v if isinstance(v, list) else [v]
                    for vv in vs:
                        b["rows"].append(vv)
                        b["cols"].append(rid)
        for fname, b in per_field.items():
            opts = types.get(fname, {})
            keyed_cols = any(isinstance(c, str) for c in b["cols"])
            if opts.get("type") in ("int", "decimal", "timestamp"):
                self.client.import_values(
                    self.index, fname,
                    cols=None if keyed_cols else b["cols"],
                    values=b["values"],
                    col_keys=b["cols"] if keyed_cols else None)
            else:
                keyed_rows = any(isinstance(r, str) for r in b["rows"])
                self.client.import_bits(
                    self.index, fname,
                    rows=None if keyed_rows else b["rows"],
                    cols=None if keyed_cols else b["cols"],
                    row_keys=b["rows"] if keyed_rows else None,
                    col_keys=b["cols"] if keyed_cols else None)
        self._records.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.flush()
