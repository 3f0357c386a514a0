"""DAX against the single node, over the cluster parity tests' table
(tests/torch_cluster_data.py: 7 shards of index "i", the keyed index "k"):
the JAX package's DaxService(2), the port's DaxService(2, device="cpu")
and the port's single node API(device="cpu"), each loaded with the same
numpy-seeded bits, values, keys and dataframes (the DAX ones through their
queryer's HTTP; a shard's dataframe into the computer that owns it).

Every query of the harness, through each queryer's HTTP, in stages: as
loaded; after computer 1 stops and computer 0 takes its shards; after a
computer is added and the shards spread again; after the harness's WRITES
(their reads too); and, for the port, after a cold restart of its
DaxService over the same directory (every shard snapshotted before the
failover, the writes in the logs after the snapshots).  The port's DAX
answers as the single node everywhere (Var and Corr within the moment
tests' 1e-6).  The JAX DAX does too, except where JAX_DAX_DIFFERS lists a
difference, which are the JAX cluster's (JAX_CLUSTER_DIFFERS, Arrow among
them: the JAX computers do not log dataframe rows, so a moved shard's are
gone), and after the writes on the keyed index, whose Delete fails part
way on the JAX computers (test_writes).  The JAX DAX's restart loses its
PQL writes (test_torch_dax.py pins it).
"""
import json
import time
import urllib.error
import urllib.request

import pytest
import torch

import torch_cluster_data as D
from featurebase_tpu_torch.server.serialize import response_to_json

T = D.table()
QUERIES = D.queries(T)
AFTER_WRITES = QUERIES + D.WRITE_READS
JAX_DAX_DIFFERS = D.JAX_CLUSTER_DIFFERS


def jax_differs(q: str) -> bool:
    return any(d in q for d in JAX_DAX_DIFFERS)


def ids(qs):
    return [f"{i}:{q}" for i, q in qs]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def http_json(url: str, method: str, path: str, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url + path, data=data, method=method)
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read() or b"{}")


def ask(svc, idx: str, q: str):
    """A queryer's JSON answer, or its error's status and message."""
    try:
        return http_json(svc.queryer_server.url, "POST",
                         f"/index/{idx}/query", {"query": q})
    except urllib.error.HTTPError as e:
        return {"status": e.code, "error": json.loads(e.read())["error"]}


def wait_until(fn, timeout=30.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if fn():
            return True
        time.sleep(0.05)
    return False


def placed(svc, live) -> bool:
    """Every assigned shard of both indexes held by one of the `live`
    computers."""
    want = {(i, int(s)) for i, m in
            svc.controller.topology()["assignments"].items() for s in m}
    held = set().union(*(c.owned for c in live))
    return bool(want) and want <= held


def settle(svc, live):
    assert wait_until(lambda: placed(svc, live)), \
        [sorted(c.owned) for c in svc.computers]
    svc.queryer.cluster.clear_down()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from featurebase_tpu.dax.service import DaxService as JaxDaxService
    from featurebase_tpu_torch.dax.service import DaxService
    from featurebase_tpu_torch.server.api import API
    single = API(device="cpu")
    D.load(D.LocalHTTP(single), T)
    data_dir = str(tmp_path_factory.mktemp("dax"))
    port = DaxService(2, data_dir=data_dir, poll_interval=0.2, device="cpu")
    jax = JaxDaxService(2, poll_interval=0.2)
    w = {"single": single, "port": port, "jax": jax, "dir": data_dir}
    try:
        for svc in (port, jax):
            D.load(lambda m, p, b, svc=svc: http_json(
                svc.queryer_server.url, m, p, b), T)
        for shard, cols in D.frames(T).items():
            single.dataframe_ingest("i", shard, columns=cols)
            for svc in (port, jax):
                owner = [c for c in svc.computers if ("i", shard) in c.owned]
                assert len(owner) == 1, (shard, owner)
                owner[0].dataframe_ingest("i", shard, columns=cols)
        yield w
    finally:
        w["port"].close()
        jax.close()


def check(w, idx: str, q: str, jax: bool = True):
    want = response_to_json(w["single"].query(idx, q))
    got = ask(w["port"], idx, q)
    assert D.close_floats(got, want), (q, got, want)
    if "Var(" not in q and "Corr(" not in q:
        assert got == want, q
    if jax and not jax_differs(q):
        assert ask(w["jax"], idx, q) == want, q


@pytest.mark.parametrize("idx,q", QUERIES, ids=ids(QUERIES))
def test_loaded(world, idx, q):
    check(world, idx, q)


def test_failover(world):
    """Each computer snapshots its shards (the dataframe rows start the new
    logs); computer 1 stops; the poller moves its shards to computer 0,
    which loads them from the snapshots and the logs."""
    for svc in (world["port"], world["jax"]):
        for c in svc.computers:
            c.snapshot_dirty()
    snaps = world["port"].resources.snap
    assert all(snaps.latest_version("i", f"shard/{s}") == 1
               for s in range(D.SHARDS))
    for svc in (world["port"], world["jax"]):
        lost = set(svc.computers[1].owned)
        assert lost
        svc.stop_computer(1)
        settle(svc, [svc.computers[0]])
        assert lost <= svc.computers[0].owned


@pytest.mark.parametrize("idx,q", QUERIES, ids=ids(QUERIES))
def test_after_failover(world, idx, q):
    # the JAX computers log no dataframe rows: Arrow's moved shards are empty
    check(world, idx, q)


def test_scale_out(world):
    """A third computer registers; the balancer gives it half the shards,
    which it loads from the snapshots and the logs."""
    for svc in (world["port"], world["jax"]):
        new = svc.add_computer()
        live = [svc.computers[0], new]
        settle(svc, live)
        assert new.owned and svc.computers[0].owned
        assert abs(len(new.owned) - len(svc.computers[0].owned)) <= 1


@pytest.mark.parametrize("idx,q", QUERIES, ids=ids(QUERIES))
def test_after_scale_out(world, idx, q):
    check(world, idx, q)


def test_writes(world):
    """Each write through each queryer answers as the single node's, but
    the JAX DAX's keyed Delete: its computers' executor drops the deleted
    records' keys from the translate store's partitions, which the JAX
    remote store lacks, so the call fails after it has cleared some
    shards."""
    for idx, q in D.writes(T):
        want = response_to_json(world["single"].query(idx, q))
        assert ask(world["port"], idx, q) == want, q
        got = ask(world["jax"], idx, q)
        if q == 'Delete(Row(kf="teal"))':
            assert got["status"] == 500 and "partitions" in got["error"]
        else:
            assert got == want, q


@pytest.mark.parametrize("idx,q", AFTER_WRITES, ids=ids(AFTER_WRITES))
def test_after_writes(world, idx, q):
    # the JAX DAX's keyed index is left part way through its failed Delete
    check(world, idx, q, jax=idx != "k")


def test_cold_restart(world):
    """The port's DaxService closes and a new one over the same directory
    loads every shard from the snapshots and the logs written after them
    (the PQL writes among them)."""
    from featurebase_tpu_torch.dax.service import DaxService
    world["port"].close()
    svc = world["port"] = DaxService(2, data_dir=world["dir"],
                                     poll_interval=0.2, device="cpu")
    settle(svc, svc.computers)


@pytest.mark.parametrize("idx,q", AFTER_WRITES, ids=ids(AFTER_WRITES))
def test_after_restart(world, idx, q):
    check(world, idx, q, jax=False)
