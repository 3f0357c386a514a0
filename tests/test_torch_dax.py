"""DAX on the port (featurebase_tpu_torch/dax/), on the CPU.

tests/test_dax.py runs on the port's classes (tests/torch_twins.py
port_namespace: its DaxService on device="cpu"): storage, directives,
balancing, write logging, snapshot + replay recovery, failover, scale-out,
keys through the controller, databases with min-workers and the SQLite
controller state.
"""
import pytest
import torch

from torch_twins import port_namespace

globals().update(port_namespace("test_dax"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- what the port adds to the JAX tests ---------------------------------------

import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import urllib.request  # noqa: E402

import numpy as np  # noqa: E402

from featurebase_tpu_torch.core.consts import SHARD_WIDTH  # noqa: E402
from featurebase_tpu_torch.dax.service import DaxService as PortDax  # noqa: E402,E501
from featurebase_tpu_torch.ingest.roaring_import import \
    payload_from_rows  # noqa: E402
from featurebase_tpu_torch.storage import residency  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNION = "Count(Union(Row(f=1), Row(f=2), Row(f=3)))"
# what the writes of fill() leave: f=1 replaced by {9} on shard 0, f=2 on
# shard 1, the Set's f=3, and v on both records of the import
READS = {"Row(f=1)": [9], "Row(f=2)": [SHARD_WIDTH + 5], "Row(f=3)": [7],
         UNION: 3, "Sum(field=v)": (30, 2)}


def jax_dax():
    from featurebase_tpu.dax.service import DaxService
    return DaxService


def row_payload(row: int, cols) -> bytes:
    words = np.zeros(SHARD_WIDTH // 32, dtype=np.uint32)
    for c in cols:
        words[c // 32] |= np.uint32(1 << (c % 32))
    return payload_from_rows({row: words})


def fill(q):
    """An import, a PQL Set through the queryer, and a roaring import that
    replaces row f=1 of shard 0 by the column 9."""
    q.create_index("p", {})
    q.create_field("p", "f", {"type": "set"})
    q.create_field("p", "v", {"type": "int", "min": 0, "max": 1000})
    q.import_bits("p", "f", [1, 2], [5, SHARD_WIDTH + 5])
    q.import_values("p", "v", [5, SHARD_WIDTH + 5], [10, 20])
    q.query("p", "Set(7, f=3)")
    q.import_roaring_shard("p", 0, {"f": {"data": row_payload(1, [9]),
                                          "replace": True}})


def reads(svc) -> dict:
    """READS's answers through the queryer, rows as column lists."""
    out = {}
    for q in READS:
        r = svc.queryer.query("p", q)[0]
        if hasattr(r, "columns"):
            r = [int(c) for c in r.columns()]
        elif hasattr(r, "val"):
            r = (r.val, r.count)
        out[q] = r
    return out


def restarted(cls, data_dir: str, **kw) -> dict:
    """reads() of a DaxService(1) started cold over a copy of data_dir."""
    copy = data_dir + f"-{cls.__module__.split('.')[0]}"
    shutil.copytree(data_dir, copy)
    with cls(n_computers=1, data_dir=copy, **kw) as svc:
        assert wait_until(lambda: len(svc.computers[0].owned) == 2)
        return reads(svc)


def test_acknowledged_writes_survive_a_cold_restart(tmp_path):
    """Every write a computer acknowledged is in the writelogger: the PQL
    Set through the queryer and the roaring replace import read back after
    a cold restart, as before it."""
    d = str(tmp_path / "dax")
    with PortDax(n_computers=1, data_dir=d, device="cpu") as svc:
        fill(svc.queryer)
        assert reads(svc) == READS
        kinds = {e["op"] for s in (0, 1)
                 for v in svc.resources.wl.versions("p", f"shard/{s}")
                 for e in svc.resources.wl.read("p", f"shard/{s}", v)}
        assert kinds == {"bits", "vals", "pql_ast", "roaring"}
    assert restarted(PortDax, d, device="cpu") == READS


def test_jax_dax_loses_a_pql_set_on_restart(tmp_path):
    """The JAX computer logs a PQL write only with a local WAL, which a
    computer lacks: the Set answers, and a cold restart loses it."""
    d = str(tmp_path / "dax")
    with jax_dax()(n_computers=1, data_dir=d) as svc:
        q = svc.queryer
        q.create_index("p", {})
        q.create_field("p", "f", {"type": "set"})
        q.import_bits("p", "f", [1, 2], [5, 1048581])
        q.query("p", "Set(7, f=3)")
        assert q.query("p", UNION) == [3]
    with jax_dax()(n_computers=1, data_dir=d) as svc:
        assert wait_until(lambda: len(svc.computers[0].owned) == 2)
        assert svc.queryer.query("p", UNION) == [2]


def test_a_jax_directory_restarts_in_the_port(tmp_path):
    """A directory the JAX DaxService wrote (its controller's SQLite state,
    snapshots and writelogs) starts the port's DaxService cold, which
    answers as the JAX one started over it: after the snapshot, the JAX
    computer logged the values but neither the PQL Set nor the roaring
    import (the JAX API logs both only with a local WAL), so both restarts
    lose those two."""
    d = str(tmp_path / "dax")
    with jax_dax()(n_computers=1, data_dir=d) as svc:
        q = svc.queryer
        fill(q)
        svc.computers[0].snapshot_dirty()
        q.query("p", f"Set({SHARD_WIDTH + 6}, f=2)")
        q.import_roaring_shard("p", 0, {"f": {"data": row_payload(1, [11]),
                                              "replace": True}})
        q.import_values("p", "v", [5], [15])
        assert reads(svc)["Row(f=1)"] == [11]
    jax = restarted(jax_dax(), d)
    assert restarted(PortDax, d, device="cpu") == jax
    assert jax == {**READS, "Sum(field=v)": (35, 2)}


def test_a_port_directory_restarts_in_jax(tmp_path):
    """A directory the port wrote starts the JAX DaxService cold: it
    answers as the port's restart but where the replace import shows,
    which the JAX replay merges into row f=1 where the port replaces it
    (the JAX replay does not read "replace"; ROADMAP.md's watch-list)."""
    d = str(tmp_path / "dax")
    with PortDax(n_computers=1, data_dir=d, device="cpu") as svc:
        fill(svc.queryer)
    assert restarted(PortDax, d, device="cpu") == READS
    assert restarted(jax_dax(), d) == {**READS, "Row(f=1)": [5, 9],
                                       UNION: 4}


def test_snapshot_carries_dataframe_rows(tmp_path):
    """A shard's dataframe rows are logged, and start the new log after a
    snapshot, so a restart reads them back."""
    d = str(tmp_path / "dax")
    cols = {"_id": [5, 9], "x": [1.5, 2.5]}
    with PortDax(n_computers=1, data_dir=d, device="cpu") as svc:
        fill(svc.queryer)
        svc.computers[0].dataframe_ingest("p", 0, columns=cols)
        svc.computers[0].snapshot_dirty()
        assert svc.resources.snap.latest_version("p", "shard/0") == 1
    copy = d + "-again"
    shutil.copytree(d, copy)
    with PortDax(n_computers=1, data_dir=copy, device="cpu") as svc:
        assert wait_until(lambda: len(svc.computers[0].owned) == 2)
        frame = svc.computers[0].holder.index("p").dataframe.shards[0]
        assert {k: v.tolist() for k, v in frame.columns.items()} == cols
        assert reads(svc) == READS


def test_a_shard_given_up_leaves_no_device_copy():
    """A computer that loses shards in a rebalance drops their fragments,
    their mirrors' residency bytes and every stacked copy gathered from
    them."""
    with PortDax(n_computers=1, poll_interval=60, device="cpu") as svc:
        q = svc.queryer
        q.create_index("e", {})
        q.create_field("e", "f", {"type": "set"})
        q.create_field("e", "v", {"type": "int", "min": 0, "max": 1000})
        cols = [s * SHARD_WIDTH + 1 for s in range(6)]
        q.import_bits("e", "f", [1] * 6, cols)
        q.import_values("e", "v", cols, [10, 20, 30, 40, 50, 60])
        c0 = svc.computers[0]
        for pql in ("Count(Row(f=1))", "TopN(f)", "Sum(field=v)",
                    "MinRow(field=f)"):
            q.query("e", pql)
        frags = {}
        for f in c0.holder.index("e").fields.values():
            for v in f.views.values():
                for s, fr in v.fragments.items():
                    frags.setdefault(s, []).append(fr)
        mgr = residency.residency()

        def mirrors(s):
            return [k for k in (fr._residency_key() for fr in frags[s])
                    if k in mgr._entries]

        def stacked(s):
            return c0.executor.plan_executor.built_from(
                {id(fr) for fr in frags[s]})
        before = {s: mirrors(s) + stacked(s) for s in range(6)}
        assert all(mirrors(s) and stacked(s) for s in range(6))
        svc.add_computer()
        assert wait_until(lambda: len(svc.computers[1].owned) == 3)
        lost = sorted(s for _, s in svc.computers[1].owned)
        kept = sorted(set(range(6)) - set(lost))
        assert sorted(s for _, s in c0.owned) == kept
        for s in lost:
            assert all(fr._dev is None for fr in frags[s])
            assert all(s not in v.fragments
                       for f in c0.holder.index("e").fields.values()
                       for v in f.views.values())
            assert not any(k in mgr._entries for k in before[s])
        assert all(mirrors(s) for s in kept)
        assert q.query("e", "Count(Row(f=1))") == [6]


def test_a_computer_with_a_local_wal_logs_each_write_once(tmp_path):
    """A computer built with a data_dir keeps a local WAL beside the
    writelogger: each kind of write goes to both, once, and the computer
    started again over the data_dir reads them back from its WAL."""
    from featurebase_tpu_torch.dax.computer import DaxComputerAPI
    from featurebase_tpu_torch.dax.storage import (ResourceManager,
                                                   Snapshotter, Writelogger)
    rm = ResourceManager(Writelogger(str(tmp_path / "wl")),
                         Snapshotter(str(tmp_path / "snap")))

    def computer():
        return DaxComputerAPI("c0", "http://127.0.0.1:9", rm,
                              data_dir=str(tmp_path / "local"), device="cpu")
    c = computer()
    c.create_index("p", {})
    c.create_field("p", "f", {"type": "set"})
    c.create_field("p", "v", {"type": "int", "min": 0, "max": 1000})
    c._load_shard("p", 0)
    c.import_bits("p", "f", [1], [5])
    c.import_values("p", "v", [5], [10])
    c.query("p", "Set(7, f=3)")
    c.import_roaring("p", "f", 0, row_payload(2, [8]))
    c.import_roaring_shard("p", 0, {"f": {"data": row_payload(1, [9]),
                                          "replace": True}})
    c.dataframe_ingest("p", 0, columns={"_id": [5], "x": [1.5]})
    writes = ["bits", "vals", "pql_ast", "roaring", "roaring", "dataframe"]
    assert [e["op"] for e in rm.wl.read("p", "shard/0", 0)] == writes
    with open(tmp_path / "local" / "wal.jsonl") as fh:
        local = [json.loads(line)["op"] for line in fh]
    assert [op for op in local if op in writes] == writes
    want = {"Row(f=1)": [9], "Row(f=2)": [8], "Row(f=3)": [7]}
    for api in (c, computer()):
        assert {q: [int(x) for x in api.query("p", q)[0].columns()]
                for q in want} == want
        assert api.query("p", "Sum(field=v)")[0].val == 10


def test_acknowledged_writes_survive_moves_and_snapshots(tmp_path):
    """A writer keeps writing through the queryer while a computer joins,
    every computer snapshots, and a computer stops: each write that was
    acknowledged reads back after a cold restart.  (A write that a stale
    route sends to a computer that no longer holds its shard is refused,
    not acknowledged.)"""
    import threading
    import time
    d = str(tmp_path / "dax")
    n_shards = 8
    acked = {1: [], 2: []}
    stage = {"now": "start"}
    by_stage: dict = {}
    stop = threading.Event()

    def writer(q):
        i = 0
        while not stop.is_set():
            i += 1
            col = (i % n_shards) * SHARD_WIDTH + 100 + i
            row = 1 + i % 2
            try:
                if row == 1:
                    q.import_bits("w", "f", [1], [col])
                else:
                    q.query("w", f"Set({col}, f=2)")
            except Exception:  # noqa: BLE001 — not acknowledged
                continue
            acked[row].append(col)
            by_stage[stage["now"]] = by_stage.get(stage["now"], 0) + 1

    with PortDax(n_computers=2, data_dir=d, poll_interval=0.1,
                 device="cpu") as svc:
        q = svc.queryer
        q.create_index("w", {})
        q.create_field("w", "f", {"type": "set"})
        q.import_bits("w", "f", [3] * n_shards,
                      [s * SHARD_WIDTH for s in range(n_shards)])
        t = threading.Thread(target=writer, args=(q,))
        t.start()
        try:
            time.sleep(0.5)
            stage["now"] = "scale_out"
            svc.add_computer()
            assert wait_until(lambda: len(svc.computers[2].owned) >= 2)
            time.sleep(0.5)
            stage["now"] = "snapshot"
            for c in svc.computers:
                c.snapshot_dirty()
            time.sleep(0.5)
            stage["now"] = "failover"
            svc.stop_computer(1)
            assert wait_until(lambda: not svc.computers[1].owned or all(
                ("w", s) in svc.computers[0].owned | svc.computers[2].owned
                for _, s in svc.computers[1].owned), timeout=20)
            time.sleep(1.0)
            stage["now"] = "snapshot_again"
            for c in (svc.computers[0], svc.computers[2]):
                c.snapshot_dirty()
            time.sleep(0.5)
        finally:
            stop.set()
            t.join()
    assert all(by_stage.get(k, 0) for k in
               ("start", "scale_out", "snapshot", "failover",
                "snapshot_again")), by_stage
    copy = d + "-again"
    shutil.copytree(d, copy)
    with PortDax(n_computers=1, data_dir=copy, device="cpu") as svc:
        assert wait_until(lambda: len(svc.computers[0].owned) == n_shards)
        for row, cols in acked.items():
            got = {int(c) for c in
                   svc.queryer.query("w", f"Row(f={row})")[0].columns()}
            assert set(cols) <= got, (row, sorted(set(cols) - got)[:10])


def test_a_snapshot_waits_for_a_logged_write_to_apply(tmp_path,
                                                     monkeypatch):
    """A write held between its log entry and its apply: a snapshot asked
    for meanwhile is cut only after the write applied, so the write is in
    the snapshot that replaces its log and reads back after a cold
    restart."""
    import threading
    d = str(tmp_path / "dax")
    logged, go = threading.Event(), threading.Event()
    with PortDax(n_computers=1, data_dir=d, device="cpu") as svc:
        q, c = svc.queryer, svc.computers[0]
        q.create_index("w", {})
        q.create_field("w", "f", {"type": "set"})
        q.import_bits("w", "f", [1], [3])
        append = svc.resources.append_many

        def held(bucket, key, entries, holder=None):
            append(bucket, key, entries, holder=holder)
            if entries[0].get("cols") == [11]:
                logged.set()
                go.wait(10)
        monkeypatch.setattr(svc.resources, "append_many", held)
        w = threading.Thread(target=q.import_bits, args=("w", "f", [1], [11]))
        w.start()
        assert logged.wait(10)
        snap = threading.Thread(target=c.snapshot_dirty)
        snap.start()
        snap.join(0.5)
        go.set()
        w.join()
        snap.join()
        assert svc.resources.snap.latest_version("w", "shard/0") == 1
    copy = d + "-again"
    shutil.copytree(d, copy)
    with PortDax(n_computers=1, data_dir=copy, device="cpu") as svc:
        assert wait_until(lambda: len(svc.computers[0].owned) == 1)
        got = svc.queryer.query("w", "Row(f=1)")[0].columns()
        assert [int(x) for x in got] == [3, 11]


def test_translate_store_answers_the_ports_calls():
    """The remote translate store answers the two calls the port makes of
    a translate store beside the JAX package's: /internal/translate/
    checksums on a computer, and a keyed Delete, which leaves the keys in
    the controller."""
    with PortDax(n_computers=1, device="cpu") as svc:
        q = svc.queryer
        q.create_index("k", {"keys": True, "trackExistence": True})
        q.create_field("k", "tag", {"type": "set", "keys": True})
        q.import_bits("k", "tag", None, None, row_keys=["a", "b", "a"],
                      col_keys=["x", "y", "z"])
        url = svc.computer_servers[0].url
        with urllib.request.urlopen(url + "/internal/translate/checksums",
                                    timeout=10) as r:
            sums = json.loads(r.read())
        assert sums["k"]["index"][0] >= 0 and "tag" in sums["k"]["fields"]
        assert q.query("k", 'Delete(Row(tag="b"))') == [True]
        assert q.query("k", "Count(All())") == [2]
        assert sorted(q.query("k", 'Row(tag="a")')[0].keys) == ["x", "z"]


def test_without_cuda_the_service_raises_before_it_serves(monkeypatch):
    """DaxService() runs on the card: with no CUDA and no device="cpu" it
    raises before it starts a server."""
    from featurebase_tpu_torch.dax import service
    started = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(service.Server, "start",
                        lambda self: started.append(self) or self)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PortDax(n_computers=1)
    assert started == []
    monkeypatch.undo()
    with PortDax(n_computers=2, device="cpu") as svc:
        assert {str(a.executor.device)
                for a in svc.computers + [svc.queryer]} == {"cpu"}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_dax_on_the_cpu_answers_over_http(tmp_path):
    """`python -m featurebase_tpu_torch dax --cpu` serves its queryer on
    --bind: an index made, imported and queried over HTTP."""
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "featurebase_tpu_torch", "dax", "--cpu",
         "--computers", "2", "--data-dir", str(tmp_path / "dax"),
         "--bind", f"127.0.0.1:{port}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def call(method, path, body):
        req = urllib.request.Request(url + path, method=method,
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read() or b"{}")
    try:
        assert proc.stdout.readline().startswith(
            "featurebase_tpu_torch dax: controller=http://127.0.0.1:")
        call("POST", "/index/i", {"options": {}})
        call("POST", "/index/i/field/f", {"options": {"type": "set"}})
        call("POST", "/index/i/field/f/import",
             {"rowIDs": [1, 1, 2], "columnIDs": [3, SHARD_WIDTH + 3, 4]})
        got = call("POST", "/index/i/query",
                   {"query": "Set(9, f=1) Count(Row(f=1))"})
        assert got == {"results": [True, 3]}
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
