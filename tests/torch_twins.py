"""Twins of the JAX package's server-surface tests: the same test bodies,
run on featurebase_tpu_torch, with every request they make answered by both
packages and compared.

twin_namespace(name) reads tests/<name>.py and runs its source with each
import of featurebase_tpu.<x> turned into featurebase_tpu_torch.<x>, except
the API, HTTP server and gRPC server, which come from this module:

- API(**kw) is a Pair of the JAX package's API(**kw) and the port's
  API(device="cpu", **kw) (a data_dir d is the JAX one's; the port's is
  d + "-port").  A method call runs on both: their answers must be equal
  (test_torch_api.canon) and the port's comes back, or both must raise the
  same error (type, status, message) and the port's is raised.  Model
  objects (an index, a field, a fragment, the monitor...) come back as
  Pairs, so a chain such as api.holder.index("i").field("m") drives both.
  Setting an attribute sets it on both; a port Auth is rebuilt as the JAX
  package's for the JAX API.
- Server(api=pair) starts the JAX package's HTTP server on the pair's JAX
  API, the port's on its port API, and a proxy in front of both.  Its url is
  the proxy's: each request goes to the JAX server and then to the port's,
  the two answers are compared (see compare below) and the port's is
  returned.  A mismatch answers 599 and is recorded; assert_no_mismatch
  fails the test on any.
- GRPCServer(api=pair) starts both packages' gRPC servers; its address is
  the port's, and make_channel_callables gives callables that send each
  request to both and compare the replies (bytes, or status code and
  details), returning the port's.

So the JAX test's own asserts run on the port's answers, and every answer
the port gives is held against the JAX package's.

What differs by nature, and is not compared (the list the test files and
ROADMAP.md's watch-list name):
- the version string (/version), each package's own;
- the platform: /status "devices" (jax devices against the torch device),
  /internal/diagnostics "backend", "numDevices" and "deviceName";
- times: durations, uptimes, query runtimes and ages, transaction
  deadlines, event timestamps and stacks, profile span times;
- each package's process-wide registries: /metrics.json values (its key
  set is compared), /metrics, /internal/mem-usage, /internal/disk-usage;
- /debug/pprof bodies (this process's threads and samples; statuses are
  compared), and /debug/pprof/heap goes to the port's server alone:
  tracemalloc is process-wide, so two packages' windows in one process
  would stop each other's;
- /internal/fragments "generation" (the port's start at a base of their
  own), "deviceResident", "deviceRows" and "dirtySlots" (device mirrors).

port_namespace(name) runs tests/<name>.py on the port alone, for the tests
that build their own nodes (the cluster's): no pairs, every import from
featurebase_tpu_torch, each TestCluster, API and Executor(holder) on the
CPU.
"""
from __future__ import annotations

import json
import os
import re
import ssl
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from featurebase_tpu.server import api as jax_api
from featurebase_tpu.server import auth as jax_auth
from featurebase_tpu.server import grpc_server as jax_grpc
from featurebase_tpu.server import http_server as jax_http
from featurebase_tpu_torch.executor.executor import Executor as PortExecutor
from featurebase_tpu_torch.model.field import Field
from featurebase_tpu_torch.model.fragment import Fragment
from featurebase_tpu_torch.model.index import Holder, Index
from featurebase_tpu_torch.model.view import View
from featurebase_tpu_torch.server import api as port_api
from featurebase_tpu_torch.server import auth as port_auth
from featurebase_tpu_torch.server import grpc_server as port_grpc
from featurebase_tpu_torch.server import http_server as port_http
from featurebase_tpu_torch.server.api import APIError  # noqa: F401
from featurebase_tpu_torch.storage.translate import (FieldTranslateStore,
                                                     IndexTranslateStore)
from featurebase_tpu_torch.utils.monitor import (DiagnosticsCollector,
                                                 ErrorMonitor)
from featurebase_tpu_torch.utils.tracker import (QueryTracker,
                                                 TransactionStore)
from test_torch_api import canon

TESTS = os.path.dirname(os.path.abspath(__file__))

# port objects that come back as Pairs rather than compared values
PAIRED = (Holder, Index, Field, View, Fragment, ErrorMonitor,
          DiagnosticsCollector, QueryTracker, TransactionStore, PortExecutor,
          FieldTranslateStore, IndexTranslateStore)

MISMATCHES: list = []


def error_form(e: Exception) -> tuple:
    return type(e).__name__, getattr(e, "status", None), str(e)


# -- the API pair --------------------------------------------------------------

def jax_side(v):
    if isinstance(v, Pair):
        return v._j
    if isinstance(v, port_auth.Auth):
        return jax_auth_of(v)
    return v


def port_side(v):
    return v._p if isinstance(v, Pair) else v


def jax_auth_of(a: port_auth.Auth) -> jax_auth.Auth:
    """The JAX package's Auth with the same verifier and grants."""
    v = a.verifier
    pem = None
    if v.public_key is not None:
        from cryptography.hazmat.primitives.serialization import (
            Encoding, PublicFormat)
        pem = v.public_key.public_bytes(Encoding.PEM,
                                        PublicFormat.SubjectPublicKeyInfo)
    return jax_auth.Auth(
        jax_auth.TokenVerifier(
            secret=v.secret, public_key_pem=pem, issuer=v.issuer,
            audience=v.audience, groups_claim=v.groups_claim,
            name_claim=v.name_claim, leeway=v.leeway),
        jax_auth.GroupAuthorizer(a.authorizer.grants,
                                 admin_group=a.authorizer.admin_group))


def on_both(fj, fp):
    """fj() and fp(): equal answers (the port's returned, or a Pair of
    model objects), or the same error (the port's raised)."""
    outs = []
    for f in (fj, fp):
        try:
            outs.append((None, f()))
        except AssertionError:
            raise
        except Exception as e:  # noqa: BLE001 — compared across packages
            outs.append((e, None))
    (je, j), (pe, p) = outs
    if je is not None or pe is not None:
        assert je is not None and pe is not None and \
            error_form(je) == error_form(pe), (je, pe, j, p)
        raise pe
    if isinstance(p, PAIRED):
        return Pair(j, p)
    assert canon(j) == canon(p), (canon(j), canon(p))
    return p


class Pair:
    """A JAX package object and the port's counterpart, driven together
    (see the module docstring)."""

    __slots__ = ("_j", "_p")

    def __init__(self, j, p):
        object.__setattr__(self, "_j", j)
        object.__setattr__(self, "_p", p)

    def __getattr__(self, name):
        a, b = getattr(self._j, name), getattr(self._p, name)
        if callable(b) and not isinstance(b, type):
            def call(*args, **kw):
                return on_both(
                    lambda: a(*map(jax_side, args),
                              **{k: jax_side(v) for k, v in kw.items()}),
                    lambda: b(*map(port_side, args),
                              **{k: port_side(v) for k, v in kw.items()}))
            return call
        return Pair(a, b) if isinstance(b, PAIRED) else b

    def __setattr__(self, name, v):
        setattr(self._j, name, jax_side(v))
        setattr(self._p, name, port_side(v))


def API(*args, data_dir=None, **kw):
    """A Pair of the JAX package's API and the port's API(device="cpu")."""
    return Pair(jax_api.API(*args, data_dir=data_dir, **kw),
                port_api.API(*args, device="cpu",
                             data_dir=data_dir and data_dir + "-port", **kw))


# -- the HTTP pair and its proxy ------------------------------------------------

def _fetch(url: str, method: str, body: bytes, headers: dict):
    req = urllib.request.Request(url, data=body if body else None,
                                 method=method)
    for k, v in headers.items():
        req.add_header(k, v)
    ctx = None
    if url.startswith("https"):
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    try:
        with urllib.request.urlopen(req, timeout=60, context=ctx) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _drop(obj, keys):
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(x, keys) for x in obj]
    return obj


def _span_names(span):
    return [span.get("name"),
            [_span_names(c) for c in span.get("children", [])]]


TIMES = {"uptime", "uptime_s", "duration_us", "runtime", "start", "age",
         "deadline", "ts", "stack", "created"}


def normalize(path: str, body):
    """The comparable part of a JSON answer of `path` (module docstring)."""
    if path == "/metrics.json":
        return sorted(body)
    if path in ("/internal/mem-usage", "/internal/disk-usage", "/version"):
        return sorted(body)
    if path == "/status":
        return _drop(body, {"devices"})
    if path == "/internal/diagnostics":
        return _drop(body, TIMES | {"backend", "numDevices", "deviceName",
                                    "version"})
    if path == "/internal/fragments":
        return _drop(body, {"generation", "deviceResident", "deviceRows",
                            "dirtySlots"})
    if isinstance(body, dict) and isinstance(body.get("profile"), dict):
        body = dict(body, profile=_span_names(body["profile"]))
    return _drop(body, TIMES)


def compare(method: str, path: str, j, p):
    """-> (answer to return, mismatch or None) for one request's JAX answer
    j and port answer p, each (status, content type, bytes)."""
    if j[0] != p[0] or j[1] != p[1]:
        return p, ("status", j[:2], p[:2], j[2][:300], p[2][:300])
    if path.startswith("/debug/pprof/") or path == "/metrics":
        return p, None
    if "json" not in p[1]:
        return p, None if j[2] == p[2] else ("body", j[2][:300], p[2][:300])
    jb, pb = normalize(path, json.loads(j[2])), normalize(path,
                                                          json.loads(p[2]))
    return p, None if jb == pb else ("json", jb, pb)


class Server:
    """Both packages' HTTP servers behind one comparing proxy."""

    def __init__(self, api: Pair = None, host: str = "127.0.0.1",
                 port: int = 0, defer_api: bool = False, tls_cert=None,
                 tls_key=None):
        assert isinstance(api, Pair), "twin servers need an API pair"
        self.api = api
        tls = dict(tls_cert=tls_cert, tls_key=tls_key)
        self.jax = jax_http.Server(api=api._j, **tls)
        self.port_server = port_http.Server(api=api._p, **tls)
        self.mismatches: list = []
        twin = self

        class Proxy(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _any(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                headers = {k: self.headers[k] for k in (
                    "Authorization", "Content-Type",
                    "X-Featurebase-Transaction") if self.headers.get(k)}
                path = self.path.split("?")[0].rstrip("/")
                j = None
                if path != "/debug/pprof/heap":
                    j = _fetch(twin.jax.url + self.path, self.command, body,
                               headers)
                p = _fetch(twin.port_server.url + self.path, self.command,
                           body, headers)
                out, bad = compare(self.command, path, j, p) if j else \
                    (p, None)
                if bad is not None:
                    twin.mismatches.append((self.command, self.path, bad))
                    MISMATCHES.append((self.command, self.path, bad))
                    out = (599, "application/json", json.dumps(
                        {"error": f"packages differ: {bad!r}"}).encode())
                self.send_response(out[0])
                self.send_header("Content-Type", out[1])
                self.send_header("Content-Length", str(len(out[2])))
                self.end_headers()
                self.wfile.write(out[2])

            do_GET = do_POST = do_DELETE = _any

        self.httpd = ThreadingHTTPServer((host, port), Proxy)
        self.tls = bool(tls_cert)
        if tls_cert:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True)
        self.port = self.httpd.server_address[1]
        self._thread = None

    def start(self):
        self.jax.start()
        self.port_server.start()
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)
        self.jax.stop()
        self.port_server.stop()

    @property
    def url(self) -> str:
        return f"{'https' if self.tls else 'http'}://127.0.0.1:{self.port}"


def assert_no_mismatch():
    """Fail on any answer the packages gave differently since the last
    call."""
    bad = list(MISMATCHES)
    MISMATCHES.clear()
    assert not bad, bad[:3]


# -- the gRPC pair ----------------------------------------------------------------

_LAST_GRPC: list = []


class GRPCServer:
    """Both packages' gRPC servers; address and port are the port's."""

    def __init__(self, api: Pair = None, host: str = "127.0.0.1",
                 port: int = 0, max_workers: int = 8, tls_cert=None,
                 tls_key=None):
        assert isinstance(api, Pair), "twin servers need an API pair"
        kw = dict(max_workers=max_workers, tls_cert=tls_cert,
                  tls_key=tls_key)
        self.api = api
        self.tls_cert = tls_cert
        self.jax = jax_grpc.GRPCServer(api=api._j, **kw)
        self.port_server = port_grpc.GRPCServer(api=api._p, host=host,
                                                port=port, **kw)
        self.port = self.port_server.port
        self.address = self.port_server.address

    def start(self):
        self.jax.start()
        self.port_server.start()
        _LAST_GRPC.append(self)
        return self

    def stop(self, grace: float = 1.0):
        self.jax.stop(grace)
        self.port_server.stop(grace)
        _LAST_GRPC.remove(self)


def make_channel_callables(channel):
    """Callables on `channel` (to the port's server of the running
    GRPCServer pair) that send each request to both servers and compare."""
    import grpc
    twin = _LAST_GRPC[-1]
    if twin.tls_cert:
        with open(twin.tls_cert, "rb") as fh:
            creds = grpc.ssl_channel_credentials(root_certificates=fh.read())
        jchan = grpc.secure_channel(
            f"localhost:{twin.jax.port}", creds,
            options=(("grpc.ssl_target_name_override", "localhost"),))
    else:
        jchan = grpc.insecure_channel(twin.jax.address)
    jcalls = jax_grpc.make_channel_callables(jchan)
    pcalls = port_grpc.make_channel_callables(channel)

    def pair(name):
        def call(request, **kw):
            jreq = type(jcalls_req[name]).FromString(
                request.SerializeToString())
            outs = []
            for fn, req in ((jcalls[name], jreq), (pcalls[name], request)):
                try:
                    r = fn(req, **kw)
                    outs.append((None, list(r) if not hasattr(
                        r, "SerializeToString") else r))
                except grpc.RpcError as e:
                    outs.append((e, None))
            (je, j), (pe, p) = outs
            if je is not None or pe is not None:
                assert je is not None and pe is not None and \
                    (je.code(), je.details()) == (pe.code(), pe.details()), \
                    (je, pe)
                raise pe
            ser = (lambda m: [x.SerializeToString() for x in m]
                   if isinstance(m, list) else m.SerializeToString())
            assert ser(j) == ser(p), (name, j, p)
            return p
        return call

    from featurebase_tpu.proto import pilosa_pb2 as jpb
    jcalls_req = {
        "QuerySQL": jpb.QuerySQLRequest(), "QuerySQLUnary":
        jpb.QuerySQLRequest(), "QueryPQL": jpb.QueryPQLRequest(),
        "QueryPQLUnary": jpb.QueryPQLRequest(),
        "Inspect": jpb.InspectRequest(),
        "CreateIndex": jpb.CreateIndexRequest(),
        "GetIndex": jpb.GetIndexRequest(),
        "GetIndexes": jpb.GetIndexesRequest(),
        "DeleteIndex": jpb.DeleteIndexRequest()}
    return {name: pair(name) for name in pcalls}


# -- the JAX test modules, on the port --------------------------------------------

PORT_IMPORT = re.compile(r"\bfeaturebase_tpu\b(?!_)")
TWINNED = re.compile(
    r"from featurebase_tpu\.server\.(api|http_server|grpc_server) import")


# the constructors a JAX test calls that run on a device in the port: each
# call gets device="cpu" (port_namespace)
ON_CPU = [
    (re.compile(r"\bTestCluster\(([^()]*)\)"), r'TestCluster(\1, device="cpu")'),
    (re.compile(r"\bAPI\(\)"), 'API(device="cpu")'),
    (re.compile(r"\bAPI\((?!device=)([^()]+)\)"), r'API(\1, device="cpu")'),
    (re.compile(r"\bExecutor\(holder\)"), 'Executor(holder, device="cpu")'),
    (re.compile(r"\bDaxService\(([^()]*)\)"),
     r'DaxService(\1, device="cpu")'),
]


def _exec_test(name: str, src: str, path: str, drop) -> dict:
    ns = {"__name__": f"twin_{name}", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    for d in drop:
        cls, _, meth = d.partition(".")
        if meth:
            delattr(ns[cls], meth)
        else:
            del ns[cls]
    return {k: v for k, v in ns.items() if not k.startswith("__")}


def _source(name: str, subs) -> tuple:
    path = os.path.join(TESTS, f"{name}.py")
    with open(path) as fh:
        src = fh.read()
    for old, new in subs:
        assert old in src, (name, old)
        src = src.replace(old, new)
    return src, path


def port_namespace(name: str, subs=(), drop=()) -> dict:
    """The namespace of tests/<name>.py run on the port alone: every
    featurebase_tpu import from featurebase_tpu_torch (the API, the servers
    and TestCluster too), each (old, new) of `subs` replaced in the source,
    and each TestCluster, API, Executor(holder) and DaxService it builds
    given device="cpu" (ON_CPU).  The cluster tests run so: a TestCluster's nodes
    are the port's APIs behind the port's servers, and the JAX test's
    asserts hold their answers."""
    src, path = _source(name, subs)
    src = PORT_IMPORT.sub("featurebase_tpu_torch", src)
    for rx, repl in ON_CPU:
        src = rx.sub(repl, src)
    return _exec_test(name, src, path, drop)


def twin_namespace(name: str, subs=(), drop=()) -> dict:
    """The namespace of tests/<name>.py run on the port: its server-side
    imports from this module, every other featurebase_tpu import from
    featurebase_tpu_torch, then each (old, new) of `subs` replaced in the
    source, and the names in `drop` (tests that wait for a later item)
    removed."""
    src, path = _source(name, subs)
    src = TWINNED.sub("from torch_twins import", src)
    src = PORT_IMPORT.sub("featurebase_tpu_torch", src)
    return _exec_test(name, src, path, drop)
