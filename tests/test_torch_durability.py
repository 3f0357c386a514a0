"""Durability and schema changes of the port's API against the JAX
package's.

One write sequence (schema, bulk imports with keys and timestamps, PQL
writes, a dataframe, SQL views, a field and an index deleted and created
again, ID reservations) goes through an API with a data directory; a second
API over the same directory, of either package, must answer a fixed set
of queries exactly as an API of the JAX package that ran the same
sequence in memory: WAL replay, a checkpoint's snapshot plus the WAL after
it, and each crossing between the packages.  Then the TTL's view removal,
and deletes on a warm executor: the port answers from the new data (a
numpy oracle) and releases the old copies' residency bytes."""
import json
import os
from datetime import datetime

import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu_torch.server.api import API
from featurebase_tpu_torch.storage import residency
from test_torch_api import Both, canon


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(pkg, **kw):
    return JaxAPI(**kw) if pkg == "jax" else API(device="cpu", **kw)


def writes_1(api):
    """Schema, imports (ids, keys, timestamps, values), PQL writes."""
    rng = np.random.default_rng(3)
    api.create_index("d", {"trackExistence": True})
    for name, opts in (("f", {"type": "set"}), ("g", {"type": "set"}),
                       ("v", {"type": "int", "min": -1000, "max": 1000}),
                       ("dec", {"type": "decimal", "scale": 2}),
                       ("m", {"type": "mutex"}),
                       ("t", {"type": "time", "timeQuantum": "YMD"})):
        api.create_field("d", name, opts)
    cols = np.sort(rng.choice(3 * SW, 400, replace=False))
    api.import_bits("d", "f", rng.integers(0, 5, cols.size), cols)
    api.import_bits("d", "g", rng.integers(0, 3, 200), cols[::2])
    api.import_values("d", "v", cols, rng.integers(-1000, 1000, cols.size))
    api.import_values("d", "dec", cols[::3],
                      rng.integers(-5000, 5000, cols[::3].size) / 100)
    api.import_bits("d", "m", rng.integers(0, 4, 100), cols[::4])
    api.import_bits("d", "t", [1, 1, 2], [5, 6, SW + 7],
                    timestamps=["2001-03-02T00:00", "2099-01-01T00:00",
                                "2020-05-05T00:00"])
    api.import_values("d", "v", cols[:5], [0] * 5, clear=True)
    api.query("d", "Set(11, f=7) Set(12, v=-77) Clear(11, f=7) "
                   "Store(Row(f=1), g=9) Set(13, dec=1.25)")
    api.query("d", "ClearRow(f=4)")
    api.query("d", "Delete(Row(g=2))")
    api.create_index("k", {"keys": True, "trackExistence": True})
    api.create_field("k", "kf", {"type": "set", "keys": True})
    api.create_field("k", "n", {"type": "int"})
    api.import_bits("k", "kf", None, None, row_keys=["a", "b", "a"],
                    col_keys=["r1", "r2", "r3"])
    api.import_values("k", "n", None, [5, 6], col_keys=["r1", "r4"])
    api.query("k", 'Set("r9", kf="c") Set("r2", n=8)')
    api.dataframe_ingest("d", 0, columns={"_id": [1, 2, 3, 5],
                                          "price": [0.5, 1.5, 2.5, 3.5]})
    api.create_sql_view("cheap", "SELECT * FROM d WHERE v < 0")
    api.create_sql_view("gone", "SELECT 1")
    api.reserve_ids("d", "ingest", "s1", 0, 100)
    api.commit_ids("d", "ingest", "s1", 0, 100)


def writes_2(api):
    """After a checkpoint: a field and an index deleted and created again,
    more writes, a view dropped, a second dataframe batch."""
    api.delete_field("d", "g")
    api.create_field("d", "g", {"type": "set"})
    api.import_bits("d", "g", [1, 1, 5], [2, SW + 9, 2 * SW])
    api.create_index("tmp")
    api.create_field("tmp", "x")
    api.query("tmp", "Set(1, x=1)")
    api.delete_index("tmp")
    api.create_index("tmp")
    api.create_field("tmp", "x")
    api.query("tmp", "Set(2, x=2)")
    api.query("d", "Set(3, f=2) Set(SW, v=999)".replace("SW", str(SW)))
    api.delete_sql_view("gone")
    api.dataframe_ingest("d", 1, columns={"_id": [SW + 9],
                                          "price": [9.5]})
    api.reserve_ids("d", "ingest", "s1", 1, 50)


QUERIES = [
    ("d", "Count(All())"), ("d", "Row(f=1)"), ("d", "TopN(f)"),
    ("d", "Row(g=9)"), ("d", "Row(g=1)"), ("d", "Count(Row(g=2))"),
    ("d", "Sum(field=v)"), ("d", "Min(field=v)"), ("d", "Max(field=dec)"),
    ("d", "Row(v == -77)"), ("d", "Distinct(field=v)"), ("d", "Rows(m)"),
    ("d", "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))"),
    ("d", "Row(t=1, from='2001-01-01T00:00', to='2002-01-01T00:00')"),
    ("d", "Extract(Limit(All(), limit=8), Rows(f), Rows(v), Rows(dec))"),
    ("d", "Arrow(Row(f=2))"), ("d", 'Apply(Row(f=1), "v * 2", "sum")'),
    ("k", "Extract(All(), Rows(kf), Rows(n))"), ("k", "TopN(kf)"),
    ("k", 'Count(Row(kf="a"))'), ("tmp", "Row(x=1)"), ("tmp", "Row(x=2)"),
]


def answers(api):
    out = [canon(api.query(i, q)[0]) for i, q in QUERIES]
    out.append(("views", dict(api.holder.sql_views)))
    out.append(("schema", api.schema()))
    return out


def replayed_ids(api):
    """writes_2's reservation asked for again at its offset."""
    return [r.to_json() for r in api.reserve_ids("d", "ingest", "s1", 1, 50)]


@pytest.fixture(scope="module")
def reference():
    """The answers of a JAX API that ran both write sets in memory."""
    api = JaxAPI()
    writes_1(api)
    writes_2(api)
    return answers(api)


@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("jax", "port"), ("port", "jax")])
def test_restart(tmp_path, reference, writer, reader, checkpoint):
    """A data directory written by one package's API and opened by
    another's: WAL replay alone, or a checkpoint's snapshot and the WAL
    after it."""
    d = str(tmp_path / "node")
    api = make(writer, data_dir=d)
    writes_1(api)
    if checkpoint:
        api.checkpoint()
        with open(os.path.join(d, "wal.jsonl")) as fh:
            assert fh.read() == ""
    writes_2(api)
    assert answers(api) == reference
    assert replayed_ids(api) == [{"start": 101, "end": 150}]
    again = make(reader, data_dir=d)
    assert again.wal_replay_errors == 0
    assert answers(again) == reference
    # the allocator is kept by a snapshot, not by the WAL (in both
    # packages): without a checkpoint the reservation starts afresh, with
    # one the offset committed before it stands and offset 1 is new
    assert replayed_ids(again) == [{"start": 101 if checkpoint else 1,
                                    "end": 150 if checkpoint else 50}]


def test_checkpoint_needs_a_data_dir():
    both = Both()
    assert both.call("checkpoint")[1] == 400


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_snapshot_crosses(tmp_path, reference, writer, reader):
    """storage/snapshot.py's save of either package loads in the other's
    (the holder alone: idalloc through the API's checkpoint above)."""
    from featurebase_tpu.storage import snapshot as jax_snap
    from featurebase_tpu_torch.storage import snapshot as port_snap
    api = make(writer)
    writes_1(api)
    writes_2(api)
    path = str(tmp_path / "snap")
    (jax_snap if writer == "jax" else port_snap).save(api.holder, path)
    holder = (jax_snap if reader == "jax" else port_snap).load(path)
    assert answers(make(reader, holder=holder)) == reference
    assert sorted(os.listdir(path)) == ["dataframe", "fragments",
                                        "schema.json", "translate",
                                        "views.json"]


def write_wal(d, entries):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "wal.jsonl"), "w") as fh:
        for e in entries:
            fh.write(json.dumps(e) + "\n")


GOOD = [{"op": "create_index", "name": "t"},
        {"op": "create_field", "i": "t", "f": "f"},
        {"op": "bits", "i": "t", "f": "f", "rows": [0, 0], "cols": [1, 2]},
        {"op": "pql", "i": "t", "q": "Set(3, f=0)"},
        {"op": "create_database", "name": "db1", "options": {"x": 1}},
        {"op": "create_function", "name": "fn", "def": {"body": "1"}},
        {"op": "drop_function", "name": "fn"}]


@pytest.mark.parametrize("bad", [
    {"op": "totally_bogus"},
    {"op": "roaring", "i": "t", "f": "f", "shard": 0, "data": ""},
    {"op": "schema_log", "idx": 1, "term": 1, "sop": {}},
    {"op": "schema_term", "term": 1, "leader": "n0"}])
def test_replay_counts_entries_it_cannot_apply(tmp_path, bad):
    """A WAL entry the port cannot apply yet (roaring, schema_log,
    schema_term) fails inside the replay and is counted like any failed
    entry; enough of them refuse startup."""
    d = str(tmp_path / "one")
    write_wal(d, GOOD + [bad] + GOOD[2:4])
    api = API(data_dir=d, device="cpu")
    assert api.wal_replay_errors == 1
    assert api.query("t", "Count(Row(f=0))") == [3]
    assert api.holder.sql_databases == {"db1": {"x": 1}}
    assert api.holder.sql_functions == {}
    d = str(tmp_path / "many")
    write_wal(d, GOOD[:1] + [bad] * 5)
    with pytest.raises(RuntimeError, match="WAL replay dropped"):
        API(data_dir=d, device="cpu")


def copies(api, index, field=None, view=None):
    """Residency keys of the device copies of an index (a field, a view)
    of this API's holder: its fragments' mirrors and the stacked entries
    its executor gathered from them."""
    frags = [fr for f in api.holder.index(index).fields.values()
             if field in (None, f.name) for vn, v in f.views.items()
             if view in (None, vn) for fr in v.fragments.values()]
    mgr = residency.residency()
    return [k for k in (fr._residency_key() for fr in frags)
            if k in mgr._entries] + \
        api.executor.plan_executor.built_from({id(fr) for fr in frags})


def held(keys):
    mgr = residency.residency()
    return sum(mgr._entries[k][0] for k in keys)


def gone(keys):
    return not any(k in residency.residency()._entries for k in keys)


def test_ttl_views_removal(tmp_path):
    """Expired time views go in both packages; the port's warm executor
    answers as the JAX package does after it and holds no copy of them."""
    both = Both()
    both.call("create_index", "i")
    both.call("create_field", "i", "t", {"type": "time",
                                         "timeQuantum": "YMD", "ttl": 3600})
    both.call("create_field", "i", "u", {"type": "time",
                                         "timeQuantum": "YMD"})
    both.call("import_bits", "i", "t", [1, 1, 2], [5, 6, SW + 1],
              timestamps=["2001-03-02T00:00", "2099-01-01T00:00",
                          "2001-03-03T00:00"])
    both.call("import_bits", "i", "u", [1], [5],
              timestamps=["2001-03-02T00:00"])
    ranged = ("Count(Row(t=1, from='2001-01-01T00:00', "
              "to='2100-01-01T00:00'))")
    for q in (ranged, "Row(t=1)", "TopN(t)"):
        both.query("i", q)
    t = both.port.holder.index("i").field("t")
    old = {k for vn in t.views if "2001" in vn
           for k in copies(both.port, "i", "t", vn)}
    kept = copies(both.port, "i", "t", "standard")
    assert old and kept, "the warm executor holds copies of both"
    mgr = residency.residency()
    before, nbytes = mgr.bytes, held(old)
    got = both.call("views_removal", now=datetime(2099, 1, 1, 2))
    assert got[0] == "ok" and "i/t" in got[1] and "i/u" not in got[1]
    assert gone(old) and not gone(kept)
    assert before - mgr.bytes == nbytes
    for q in (ranged, "Row(t=1)", "TopN(t)",
              "Rows(t, from='2001-01-01T00:00', to='2100-01-01T00:00')"):
        both.query("i", q)
    both.call("views_removal", now=datetime(2099, 1, 1, 2))


def test_recreated_field_is_not_answered_from_old_copies():
    """f=1 at columns 1, 2 and 3 counted; the field deleted and created
    again with f=1 at column 9, by as many writes.  The port answers 1 on
    the same API.  The JAX package answers 3 there: its plan cache keys
    the new fragment by the old one's name and generation (ROADMAP.md's
    watch-list; the JAX package stays as it is, and this pins it)."""
    both = Both()
    both.call("create_index", "i")
    both.call("create_field", "i", "f")
    both.call("import_bits", "i", "f", [1, 1, 1], [1, 2, 3])
    reads = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=1)))"]
    for q in reads + ["TopN(f, n=2)"]:
        both.query("i", q)
    for api in (both.jax, both.port):
        api.delete_field("i", "f")
        api.create_field("i", "f")
        api.import_bits("i", "f", [1], [9])
    for q in reads:
        assert both.port.query("i", q) == [1]
        assert both.jax.query("i", q) == [3]
    assert [(p.id, p.count) for p in
            both.port.query("i", "TopN(f, n=2)")[0].pairs] == [(1, 1)]


def test_field_delete_and_recreate_on_a_warm_executor():
    """A set and a BSI field deleted and created again under a warm
    executor: the port answers from the new data (numpy's answers), and
    the old field's copies leave the residency manager with their
    bytes."""
    both = Both()
    both.call("create_index", "i")
    both.call("create_field", "i", "f")
    both.call("create_field", "i", "v", {"type": "int"})
    both.call("import_bits", "i", "f", [1, 1, 1, 2], [1, 2, 3, SW + 4])
    both.call("import_values", "i", "v", [1, 2, 3], [5, 6, 7])
    reads = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(f=1)))",
             "TopN(f, n=2)", "Sum(field=v)", "Distinct(field=v)",
             "Count(Row(v > 5))"]
    for q in reads:
        both.query("i", q)
    mgr = residency.residency()
    keys = copies(both.port, "i", "f")
    assert keys and any(k[0] == "leaf" for k in keys)
    before, nbytes = mgr.bytes, held(keys)
    both.port.delete_field("i", "f")
    assert gone(keys) and mgr.bytes == before - nbytes
    both.port.create_field("i", "f")
    both.port.import_bits("i", "f", [1], [9])
    port = both.port
    assert port.query("i", "Count(Row(f=1))") == [1]
    assert port.query("i", "Count(Intersect(Row(f=1), Row(f=1)))") == [1]
    assert [(p.id, p.count) for p in
            port.query("i", "TopN(f, n=2)")[0].pairs] == [(1, 1)]
    # a BSI field: its stacked group and decoded values go too
    keys = copies(port, "i", "v")
    assert any(k[0] == "leaf" and k[2][0] == "vals" for k in keys)
    before, nbytes = mgr.bytes, held(keys)
    port.delete_field("i", "v")
    assert gone(keys) and mgr.bytes == before - nbytes
    port.create_field("i", "v", {"type": "int"})
    port.import_values("i", "v", [4, 5], [7, 100])
    assert canon(port.query("i", "Sum(field=v)")[0])[1:3] == (107, 2)
    assert port.query("i", "Distinct(field=v)")[0].values().tolist() == \
        [7, 100]
    assert port.query("i", "Count(Row(v > 5))") == [2]


def test_index_delete_and_recreate_on_a_warm_executor():
    port = API(device="cpu")
    rng = np.random.default_rng(8)
    cols = np.sort(rng.choice(2 * SW, 300, replace=False))
    port.create_index("x", {"trackExistence": True})
    port.create_field("x", "f")
    port.import_bits("x", "f", rng.integers(0, 3, cols.size), cols)
    for q in ("Count(All())", "Count(Not(Row(f=1)))", "TopN(f)"):
        port.query("x", q)
    mgr = residency.residency()
    keys = copies(port, "x")
    assert any(k[0] == "leaf" and k[2][0] == "ex" for k in keys)
    before, nbytes = mgr.bytes, held(keys)
    port.delete_index("x")
    assert gone(keys) and mgr.bytes == before - nbytes
    port.create_index("x", {"trackExistence": True})
    port.create_field("x", "f")
    new = cols[::10]
    rows = np.arange(new.size) % 2
    port.import_bits("x", "f", rows, new)
    assert port.query("x", "Count(All())") == [new.size]
    assert port.query("x", "Count(Not(Row(f=1)))") == [int((rows == 0).sum())]
    counts = np.bincount(rows)
    assert [(p.id, p.count) for p in port.query("x", "TopN(f)")[0].pairs] \
        == sorted(((r, int(c)) for r, c in enumerate(counts)),
                  key=lambda rc: (-rc[1], rc[0]))
