"""gRPC service (reference: server/grpc.go — pb.Pilosa service with
QuerySQL/QueryPQL streaming + unary, Inspect, index CRUD; grpcHandler:135
execSQL, :276 QueryPQL).

Own copy of featurebase_tpu/server/grpc_server.py over the port's API.
Handlers are registered generically (grpc.unary_unary_rpc_method_handler /
unary_stream) against the messages of proto/pilosa_pb2.py, so no grpc
codegen plugin is needed.  The service name on the wire is the JAX
package's, featurebase_tpu.Pilosa, so either package's client reaches
either package's server.  ``GRPCServer()`` without an API builds
``API()``, which runs on CUDA.
"""
from __future__ import annotations

import json
from concurrent import futures
from typing import Iterable, List, Optional

from featurebase_tpu_torch.proto import pilosa_pb2 as pb
from featurebase_tpu_torch.server.api import API, APIError
from featurebase_tpu_torch.server.serialize import result_to_json

_SERVICE = "featurebase_tpu.Pilosa"


def _col(v) -> pb.ColumnResponse:
    c = pb.ColumnResponse()
    if v is None:
        c.is_null = True
    elif isinstance(v, bool):
        c.bool_val = v
    elif isinstance(v, int):
        if v >= 0:
            c.uint64_val = v
        else:
            c.int64_val = v
    elif isinstance(v, float):
        c.float64_val = v
    elif isinstance(v, str):
        c.string_val = v
    else:
        c.json_val = json.dumps(v)
    return c


def _headers(names_types) -> List[pb.ColumnInfo]:
    return [pb.ColumnInfo(name=n, datatype=t or "string")
            for n, t in names_types]


def _sql_rows(api: API, sql: str):
    from featurebase_tpu_torch.sql.engine import execute_sql
    out = execute_sql(api, sql)
    headers = _headers([(f["name"], f["type"])
                        for f in out["schema"]["fields"]])
    for row in out["data"]:
        yield pb.RowResponse(headers=headers,
                             columns=[_col(v) for v in row])


def _pql_rows(api: API, index: str, pql: str):
    """PQL results flattened to tabular RowResponses (reference:
    server/grpc.go:276 QueryPQL ToRows mappings)."""
    results = api.query(index, pql)
    for r in results:
        j = result_to_json(r)
        if isinstance(j, bool):
            yield pb.RowResponse(headers=_headers([("result", "bool")]),
                                 columns=[_col(j)])
        elif isinstance(j, (int, float)):
            yield pb.RowResponse(headers=_headers([("count", "uint64")]),
                                 columns=[_col(j)])
        elif isinstance(j, dict) and "columns" in j and "keys" not in j:
            h = _headers([("_id", "uint64")])
            for c in j["columns"]:
                yield pb.RowResponse(headers=h, columns=[_col(c)])
        elif isinstance(j, dict) and "keys" in j:
            h = _headers([("_id", "string")])
            for k in (j["keys"] or []):
                yield pb.RowResponse(headers=h, columns=[_col(k)])
        elif isinstance(j, dict) and "pairs" in j:
            h = _headers([("row", "uint64"), ("count", "uint64")])
            for p in j["pairs"]:
                yield pb.RowResponse(
                    headers=h,
                    columns=[_col(p.get("id", p.get("key"))),
                             _col(p["count"])])
        elif isinstance(j, list) and j and isinstance(j[0], dict) \
                and "group" in j[0]:
            h = _headers([("group", "string"), ("count", "uint64"),
                          ("sum", "int64")])
            for g in j:
                yield pb.RowResponse(headers=h, columns=[
                    _col(json.dumps(g["group"])), _col(g["count"]),
                    _col(g.get("sum", 0))])
        else:
            yield pb.RowResponse(headers=_headers([("result", "json")]),
                                 columns=[_col(j)])


def _table(rows: Iterable[pb.RowResponse]) -> pb.TableResponse:
    rows = list(rows)
    t = pb.TableResponse()
    if rows:
        t.headers.extend(rows[0].headers)
        t.rows.extend(rows)
    return t


class GRPCServer:
    """gRPC front-end bound to an API (reference: server/grpc.go:410
    grpcServer)."""

    def __init__(self, api: Optional[API] = None, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 8,
                 tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None):
        import grpc
        self.api = api or API()
        self._grpc = grpc
        self.server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers))
        self.server.add_generic_rpc_handlers((self._handlers(),))
        if tls_cert and tls_key:
            # reference: grpc.go TLS listener from server/config.go tls.*
            with open(tls_key, "rb") as fh:
                key = fh.read()
            with open(tls_cert, "rb") as fh:
                cert = fh.read()
            creds = grpc.ssl_server_credentials([(key, cert)])
            self.port = self.server.add_secure_port(f"{host}:{port}", creds)
        else:
            self.port = self.server.add_insecure_port(f"{host}:{port}")

    def _check_auth(self, context, index=None, level="read"):
        """Bearer auth on gRPC metadata: static token == admin, else OIDC
        JWT + per-index group grant (reference: grpc.go auth interceptor
        over authn/authz)."""
        token = getattr(self.api, "auth_token", None)
        auth = getattr(self.api, "auth", None)
        if not token and auth is None:
            return
        got = dict(context.invocation_metadata()).get("authorization", "")
        if token and got == f"Bearer {token}":
            return
        if auth is not None:
            from featurebase_tpu_torch.server.auth import AuthError
            try:
                auth.check(got, index, level)
                return
            except AuthError as e:
                context.abort(
                    self._grpc.StatusCode.PERMISSION_DENIED
                    if e.status == 403
                    else self._grpc.StatusCode.UNAUTHENTICATED, str(e))
        context.abort(self._grpc.StatusCode.UNAUTHENTICATED,
                      "unauthorized")

    # -- handler table ---------------------------------------------------------

    def _handlers(self):
        grpc = self._grpc

        from featurebase_tpu_torch.server.auth import (pql_access_level,
                                                 sql_access)
        check = self._check_auth

        def wrap(fn, access=None):
            def inner(request, context):
                if access is None:
                    check(context)
                else:
                    idx, level = access(request)
                    check(context, idx, level)
                try:
                    return fn(request)
                except APIError as e:
                    context.abort(
                        grpc.StatusCode.NOT_FOUND if e.status == 404
                        else grpc.StatusCode.INVALID_ARGUMENT, str(e))
            return inner

        def wrap_stream(fn, access=None):
            def inner(request, context):
                if access is None:
                    check(context)
                else:
                    idx, level = access(request)
                    check(context, idx, level)
                try:
                    yield from fn(request)
                except APIError as e:
                    context.abort(
                        grpc.StatusCode.NOT_FOUND if e.status == 404
                        else grpc.StatusCode.INVALID_ARGUMENT, str(e))
            return inner

        api = self.api
        pql_access = (lambda req: (req.index, pql_access_level(req.pql)))
        sql_acc = (lambda req: sql_access(req.sql))
        methods = {
            "QuerySQL": grpc.unary_stream_rpc_method_handler(
                wrap_stream(lambda req: _sql_rows(api, req.sql), sql_acc),
                request_deserializer=pb.QuerySQLRequest.FromString,
                response_serializer=pb.RowResponse.SerializeToString),
            "QuerySQLUnary": grpc.unary_unary_rpc_method_handler(
                wrap(lambda req: _table(_sql_rows(api, req.sql)), sql_acc),
                request_deserializer=pb.QuerySQLRequest.FromString,
                response_serializer=pb.TableResponse.SerializeToString),
            "QueryPQL": grpc.unary_stream_rpc_method_handler(
                wrap_stream(lambda req: _pql_rows(api, req.index, req.pql),
                            pql_access),
                request_deserializer=pb.QueryPQLRequest.FromString,
                response_serializer=pb.RowResponse.SerializeToString),
            "QueryPQLUnary": grpc.unary_unary_rpc_method_handler(
                wrap(lambda req: _table(_pql_rows(api, req.index, req.pql)),
                     pql_access),
                request_deserializer=pb.QueryPQLRequest.FromString,
                response_serializer=pb.TableResponse.SerializeToString),
            "Inspect": grpc.unary_stream_rpc_method_handler(
                wrap_stream(self._inspect,
                            lambda req: (req.index, "read")),
                request_deserializer=pb.InspectRequest.FromString,
                response_serializer=pb.RowResponse.SerializeToString),
            "CreateIndex": grpc.unary_unary_rpc_method_handler(
                wrap(self._create_index,
                     lambda req: (req.name, "admin")),
                request_deserializer=pb.CreateIndexRequest.FromString,
                response_serializer=pb.CreateIndexResponse.SerializeToString),
            "GetIndex": grpc.unary_unary_rpc_method_handler(
                wrap(self._get_index),
                request_deserializer=pb.GetIndexRequest.FromString,
                response_serializer=pb.GetIndexResponse.SerializeToString),
            "GetIndexes": grpc.unary_unary_rpc_method_handler(
                wrap(self._get_indexes),
                request_deserializer=pb.GetIndexesRequest.FromString,
                response_serializer=pb.GetIndexesResponse.SerializeToString),
            "DeleteIndex": grpc.unary_unary_rpc_method_handler(
                wrap(self._delete_index,
                     lambda req: (req.name, "admin")),
                request_deserializer=pb.DeleteIndexRequest.FromString,
                response_serializer=pb.DeleteIndexResponse.SerializeToString),
        }

        class Handler(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                name = handler_call_details.method
                if not name.startswith(f"/{_SERVICE}/"):
                    return None
                return methods.get(name.rsplit("/", 1)[1])

        return Handler()

    # -- unary impls ------------------------------------------------------------

    def _create_index(self, req):
        self.api.create_index(req.name, {"keys": req.keys})
        return pb.CreateIndexResponse()

    def _get_index(self, req):
        if self.api.holder.index(req.name) is None:
            raise APIError(f"index not found: {req.name}", 404)
        return pb.GetIndexResponse(index=pb.Index(name=req.name))

    def _get_indexes(self, req):
        return pb.GetIndexesResponse(
            indexes=[pb.Index(name=n)
                     for n in sorted(self.api.holder.indexes)])

    def _delete_index(self, req):
        self.api.delete_index(req.name)
        return pb.DeleteIndexResponse()

    def _inspect(self, req):
        """Per-record field values (reference: grpc.go:502 Inspect)."""
        idx = self.api.holder.index(req.index)
        if idx is None:
            raise APIError(f"index not found: {req.index}", 404)
        fields = [f for f in idx.public_fields()
                  if not req.filter_fields or f.name in req.filter_fields]
        headers = _headers([("_id", "uint64")] +
                           [(f.name, f.options.type) for f in fields])
        from featurebase_tpu_torch.pql.ast import Call, Query
        for col in req.columns:
            ext = Call("Extract", children=[
                Call("ConstRow", {"columns": [int(col)]})] +
                [Call("Rows", {"_field": f.name}) for f in fields])
            (tbl,) = self.api.query(req.index, Query([ext]))
            for colrec in tbl.columns:
                vals = [colrec.column] + list(colrec.rows)
                yield pb.RowResponse(headers=headers,
                                     columns=[_col(v) for v in vals])

    # -- lifecycle ---------------------------------------------------------------

    def start(self):
        self.server.start()
        return self

    def stop(self, grace: float = 1.0):
        self.server.stop(grace)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"


def make_channel_callables(channel):
    """Client-side multicallables for tests/clients without codegen."""
    import grpc  # noqa: F401
    def u(name, req_cls, resp_cls):
        return channel.unary_unary(
            f"/{_SERVICE}/{name}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString)

    def s(name, req_cls, resp_cls):
        return channel.unary_stream(
            f"/{_SERVICE}/{name}",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString)

    return {
        "QuerySQL": s("QuerySQL", pb.QuerySQLRequest, pb.RowResponse),
        "QuerySQLUnary": u("QuerySQLUnary", pb.QuerySQLRequest,
                           pb.TableResponse),
        "QueryPQL": s("QueryPQL", pb.QueryPQLRequest, pb.RowResponse),
        "QueryPQLUnary": u("QueryPQLUnary", pb.QueryPQLRequest,
                           pb.TableResponse),
        "Inspect": s("Inspect", pb.InspectRequest, pb.RowResponse),
        "CreateIndex": u("CreateIndex", pb.CreateIndexRequest,
                         pb.CreateIndexResponse),
        "GetIndex": u("GetIndex", pb.GetIndexRequest, pb.GetIndexResponse),
        "GetIndexes": u("GetIndexes", pb.GetIndexesRequest,
                        pb.GetIndexesResponse),
        "DeleteIndex": u("DeleteIndex", pb.DeleteIndexRequest,
                         pb.DeleteIndexResponse),
    }
