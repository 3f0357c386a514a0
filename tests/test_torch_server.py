"""The port's server surface beside the JAX package's, on the CPU.

- Both packages' pilosa_pb2 in one process: the port builds its messages in
  a private descriptor pool, under the same wire names, so each package's
  stub talks to the other's gRPC server, both ways, with the same replies.
- `python -m featurebase_tpu_torch server --cpu` as a child process answers
  PQL and SQL over HTTP and gRPC as the JAX API does in process; without
  --cpu, on a machine without CUDA, it exits with the device rule's error.
- Eight client threads of mixed reads (HTTP and gRPC) through the port's
  Server get the serial answers.
- The copied defect kept on purpose: an HTTP import rejected for range is a
  500 in both packages (a defect kept so that answers stay equal).
- What differs by nature between the two servers' answers (the list in
  tests/torch_twins.py and ROADMAP.md's watch-list), request by request.
"""
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import grpc
import pytest
import torch

from featurebase_tpu.proto import pilosa_pb2 as jpb
from featurebase_tpu.server import grpc_server as jax_grpc
from featurebase_tpu.server import http_server as jax_http
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu.server.serialize import \
    response_to_json as jax_response_to_json
from featurebase_tpu_torch.client import Client
from featurebase_tpu_torch.proto import pilosa_pb2 as pb
from featurebase_tpu_torch.server import grpc_server, http_server
from featurebase_tpu_torch.server.api import API
from torch_twins import normalize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETUP = ["Set(1, f=1) Set(2, f=1) Set(3, f=2) Set(2000000, f=1)",
         "Set(5, g=7) Set(2, g=7)"]
READS = ["Count(Row(f=1))", "Row(f=1)", "TopN(f, n=2)", "Sum(field=v)",
         "Min(field=v)", "Max(Row(f=1), field=v)",
         "GroupBy(Rows(f), Rows(g))", "Count(Intersect(Row(f=1), Row(v > 15)))",
         "Distinct(field=v)", "Percentile(field=v, nth=50)",
         "Sort(Row(f=1), field=v, limit=2)",
         "Extract(Limit(All(), limit=3), Rows(f), Rows(v))",
         "Rows(f)", "MinRow(field=f)", "Count(Union(Row(f=2), Row(g=7)))"]
SQL = ["SELECT COUNT(*) FROM i", "SELECT _id, v FROM i ORDER BY _id",
       "SELECT SUM(v), MIN(v) FROM i WHERE v > 10"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seed(api):
    api.create_index("i")
    api.create_field("i", "f", {"type": "set"})
    api.create_field("i", "g", {"type": "set"})
    api.create_field("i", "v", {"type": "int", "min": -100, "max": 1000})
    for q in SETUP:
        api.query("i", q)
    api.import_values("i", "v", [1, 2, 3, 5, 2000000],
                      [10, 20, -30, 40, 500])
    return api


@pytest.fixture(scope="module")
def apis():
    return seed(JaxAPI()), seed(API(device="cpu"))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url, method="GET", body=None, raw=None, headers=None):
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


# -- the wire schema ----------------------------------------------------------

def test_both_pilosa_pb2_in_one_process():
    from google.protobuf import descriptor_pool
    assert pb.DESCRIPTOR.pool is not descriptor_pool.Default()
    assert jpb.DESCRIPTOR.pool is descriptor_pool.Default()
    assert pb.DESCRIPTOR.package == jpb.DESCRIPTOR.package
    names = sorted(pb.DESCRIPTOR.message_types_by_name)
    assert names == sorted(jpb.DESCRIPTOR.message_types_by_name)
    for n in names:
        assert getattr(pb, n).DESCRIPTOR.full_name == \
            getattr(jpb, n).DESCRIPTOR.full_name
    svc, jsvc = (d.services_by_name["Pilosa"] for d in (pb.DESCRIPTOR,
                                                        jpb.DESCRIPTOR))
    assert svc.full_name == jsvc.full_name == grpc_server._SERVICE
    assert [m.name for m in svc.methods] == [m.name for m in jsvc.methods]
    t = pb.TableResponse()
    row = t.rows.add()
    row.headers.add(name="count", datatype="uint64")
    row.columns.add(uint64_val=7)
    row.columns.add(is_null=True)
    row.columns.add(json_val='{"a": 1}')
    back = jpb.TableResponse.FromString(t.SerializeToString())
    assert pb.TableResponse.FromString(back.SerializeToString()) == t


@pytest.mark.parametrize("client", ["jax", "port"])
def test_grpc_across_packages(apis, client):
    """The `client` package's stub against the other package's server: the
    replies equal that stub's own package's server's, byte for byte."""
    japi, papi = apis
    js = jax_grpc.GRPCServer(api=japi).start()
    ps = grpc_server.GRPCServer(api=papi).start()
    mod, msgs = (jax_grpc, jpb) if client == "jax" else (grpc_server, pb)
    own, other = (js, ps) if client == "jax" else (ps, js)
    chans = [grpc.insecure_channel(s.address) for s in (own, other)]
    try:
        calls = [mod.make_channel_callables(c) for c in chans]
        reqs = [("QueryPQLUnary", msgs.QueryPQLRequest(index="i", pql=q))
                for q in READS if not q.startswith("Extract")]
        reqs += [("QueryPQL", msgs.QueryPQLRequest(index="i", pql=q))
                 for q in ("Row(f=1)", "TopN(f, n=2)",
                           "GroupBy(Rows(f), Rows(g))")]
        reqs += [("QuerySQLUnary", msgs.QuerySQLRequest(sql=s)) for s in SQL]
        reqs += [("QuerySQL", msgs.QuerySQLRequest(sql=s)) for s in SQL]
        reqs += [("Inspect", msgs.InspectRequest(index="i", columns=[1, 2])),
                 ("GetIndexes", msgs.GetIndexesRequest()),
                 ("GetIndex", msgs.GetIndexRequest(name="i"))]
        for name, req in reqs:
            got = [calls[k][name](req) for k in (0, 1)]
            got = [[m.SerializeToString() for m in g]
                   if not hasattr(g, "SerializeToString")
                   else g.SerializeToString() for g in got]
            assert got[0] == got[1], (name, req)
        for k in (0, 1):
            with pytest.raises(grpc.RpcError) as ei:
                calls[k]["QueryPQLUnary"](msgs.QueryPQLRequest(
                    index="nope", pql="Count(All())"))
            assert ei.value.code() == grpc.StatusCode.NOT_FOUND
    finally:
        for c in chans:
            c.close()
        js.stop()
        ps.stop()


# -- the entry point ------------------------------------------------------------

def start_child(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, "-m", "featurebase_tpu_torch", "server", *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def wait_health(url, proc, seconds=90):
    deadline = time.time() + seconds
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(proc.communicate())
        try:
            with urllib.request.urlopen(url + "/health", timeout=2):
                return
        except OSError:
            time.sleep(0.2)
    raise AssertionError("server did not come up")


def test_cli_server_on_the_cpu_answers_pql_and_sql(apis):
    japi, _ = apis
    port, gport = free_port(), free_port()
    proc = start_child("--cpu", "--bind", f"127.0.0.1:{port}",
                       "--grpc-bind", f"127.0.0.1:{gport}")
    url = f"http://127.0.0.1:{port}"
    try:
        wait_health(url, proc)
        c = Client(url)
        c.create_index("i")
        for f, opts in (("f", {"type": "set"}), ("g", {"type": "set"}),
                        ("v", {"type": "int", "min": -100, "max": 1000})):
            c.create_field("i", f, opts)
        for q in SETUP:
            c.query("i", q)
        c.import_values("i", "v", [1, 2, 3, 5, 2000000],
                        [10, 20, -30, 40, 500])
        for q in READS:
            want = jax_response_to_json(japi.query("i", q))["results"]
            assert c.query("i", q) == json.loads(json.dumps(want)), q
        from featurebase_tpu.sql.engine import execute_sql
        for s in SQL:
            assert c.sql(s) == json.loads(json.dumps(execute_sql(japi, s)))
        status = c.status()
        assert status["devices"] == ["cpu"] and status["indexes"] == ["i"]
        ch = grpc.insecure_channel(f"127.0.0.1:{gport}")
        t = grpc_server.make_channel_callables(ch)["QueryPQLUnary"](
            pb.QueryPQLRequest(index="i", pql="Count(Row(f=1))"))
        assert t.rows[0].columns[0].uint64_val == 3
        ch.close()
    finally:
        proc.terminate()
        out, err = proc.communicate(timeout=30)
    assert f"featurebase_tpu_torch serving on {url}" in out


def test_cli_server_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("the device rule's error needs a machine without CUDA")
    proc = start_child("--bind", f"127.0.0.1:{free_port()}")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in err and "serving" not in out


# -- threads ---------------------------------------------------------------------

def test_concurrent_reads_equal_serial(apis):
    """Eight client threads (five over HTTP, three over gRPC), each running
    the read mix three times in its own order, against the serial
    answers."""
    _, papi = apis
    srv = http_server.Server(api=papi).start()
    gs = grpc_server.GRPCServer(api=papi).start()
    chan = grpc.insecure_channel(gs.address)
    calls = grpc_server.make_channel_callables(chan)
    c = Client(srv.url)

    def g(q):
        return calls["QueryPQLUnary"](pb.QueryPQLRequest(
            index="i", pql=q)).SerializeToString()
    try:
        want_http = {q: c.query("i", q) for q in READS}
        want_grpc = {q: g(q) for q in READS if not q.startswith("Extract")}
        errors = []

        def worker(k):
            try:
                order = READS[k % len(READS):] + READS[:k % len(READS)]
                for _ in range(3):
                    for q in order:
                        if k < 5:
                            got = c.query("i", q)
                            if got != want_http[q]:
                                errors.append((k, q, got, want_http[q]))
                        elif q in want_grpc and g(q) != want_grpc[q]:
                            errors.append((k, q))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append((k, repr(e)))
        ts = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not errors, errors[:3]
    finally:
        chan.close()
        gs.stop()
        srv.stop()


# -- the copied defect and the differences ----------------------------------------

def test_range_rejected_http_import_is_a_500_in_both(apis):
    japi, papi = apis
    out = []
    for mod, api in ((jax_http, japi), (http_server, papi)):
        srv = mod.Server(api=api).start()
        try:
            out.append(http(srv.url + "/index/i/field/v/import", "POST",
                            {"columnIDs": [9], "values": [5000]}))
        finally:
            srv.stop()
    assert out[0] == out[1] and out[0][0] == 500, out


DIFFER = {"/status": {"devices"},
          "/internal/diagnostics": {"payload"},
          "/version": set(), "/info": set(), "/health": set()}


@pytest.mark.parametrize("path", sorted(DIFFER))
def test_differences_by_nature(apis, path):
    """Each answer equals the JAX server's but for the fields
    tests/torch_twins.py lists for its route."""
    japi, papi = apis
    answers = []
    for mod, api in ((jax_http, japi), (http_server, papi)):
        srv = mod.Server(api=api).start()
        try:
            answers.append(http(srv.url + path))
        finally:
            srv.stop()
    (js, jb), (ps, pbody) = answers
    assert js == ps == 200
    assert normalize(path, jb) == normalize(path, pbody)
    differ = {k for k in set(jb) | set(pbody) if jb.get(k) != pbody.get(k)}
    assert differ <= DIFFER[path], differ
    if path == "/status":
        assert pbody["devices"] == ["cpu"]
    if path == "/internal/diagnostics":
        j, p = jb["payload"], pbody["payload"]
        assert {k for k in set(j) | set(p) if j.get(k) != p.get(k)} <= \
            {"uptime_s", "numDevices", "backend", "deviceName", "version"}
        assert p["backend"] == "cpu" and p["numDevices"] == 1
