"""Apply, Arrow and ExternalLookup through the port's API against the JAX
package's.

Both APIs import the same records from a numpy seed: shard 0 holds 80,000
(past the 2^16 matched columns at which the JAX package's Apply decodes a
shard's BSI values on the host instead of gathering them on its device),
shards 1 and 3 a few hundred.  Fields: a set field f, an int field qty on
nine records in ten, bool b, mutex m, decimal d (scale 2), an int field w
at depth 41 on shard 1 (past the port's 31-plane kernel, so it decodes on
the host) and a keyed set field k.  Every Apply program, on both its routes, every
reduce and every error must answer alike; Apply's `mean` is a float that
both packages compute by the same numpy expression over the same int64
values, so it is compared exactly too."""
import io

import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.storage.lookup import SQLiteLookup as JaxSQLiteLookup
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.storage.lookup import (LookupError_, SQLiteLookup,
                                                  open_lookup)
from test_torch_api import Both

BIG = 80_000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def records(seed=5):
    rng = np.random.default_rng(seed)
    cols = np.concatenate([
        np.sort(rng.choice(SW, BIG, replace=False)),
        SW + np.sort(rng.choice(SW, 300, replace=False)),
        3 * SW + np.sort(rng.choice(SW, 200, replace=False))])
    n = cols.size
    return dict(cols=cols, f=rng.integers(0, 4, n),
                qty_has=rng.random(n) < 0.9,
                qty=rng.integers(-500, 2000, n), b=rng.integers(0, 2, n),
                m=rng.integers(0, 3, n), d=rng.integers(-9999, 9999, n) / 100,
                w=rng.integers(-(1 << 40), 1 << 40, n),
                k=rng.integers(0, 3, n))


@pytest.fixture(scope="module")
def data():
    return build()


def build():
    r = records()
    both = Both()
    both.call("create_index", "i", {"trackExistence": True})
    for name, opts in (("f", {"type": "set"}), ("qty", {"type": "int"}),
                       ("b", {"type": "bool"}), ("m", {"type": "mutex"}),
                       ("d", {"type": "decimal", "scale": 2}),
                       ("w", {"type": "int"}),
                       ("k", {"type": "set", "keys": True})):
        both.call("create_field", "i", name, opts)
    cols, h = r["cols"], r["qty_has"]
    both.call("import_bits", "i", "f", r["f"], cols)
    both.call("import_values", "i", "qty", cols[h], r["qty"][h])
    both.call("import_bits", "i", "b", r["b"][::3], cols[::3])
    both.call("import_bits", "i", "m", r["m"][::2], cols[::2])
    both.call("import_values", "i", "d", cols[::5], r["d"][::5])
    # w on shard 1 only: its host decode covers a whole shard a query
    on1 = (cols >> 20) == 1
    both.call("import_values", "i", "w", cols[on1][::3], r["w"][on1][::3])
    keys = ["x", "y", "z"]
    both.call("import_bits", "i", "k", None, cols[::11],
              row_keys=[keys[j] for j in r["k"][::11]])
    return both, r


# an Apply with its program in {p}: no filter, plannable filters, one the
# plan compiler refuses (the interpreter a shard), and shards out of order
APPLIES = ["Apply({p})", "Apply(Row(f=1), {p})",
           "Apply(Intersect(Row(f=1), Row(qty > 100)), {p})",
           "Apply(Row(qty != null), {p})",
           "Apply(Union(Row(f=2), Row(m=null)), {p})",
           "Options(Apply(Row(f=3), {p}), shards=[3, 1])"]

PROGRAMS = [
    '"qty * 2 + 1"', '"qty / 7"', '"-qty"', '"qty > 15"', '"qty = 20"',
    '"qty != 20"', '"case when qty > 15 then 1 else 0 end"',
    '"qty between 10 and 20"', '"qty is null"', '"qty in (10, 30)"',
    '"_id + qty"', '"qty % 7"', '"qty / 0"', '"b"', '"m + 1"', '"d * 2"',
    '"w + qty"', '"w"', '"qty + d"', '"qty > 100 and b"',
]
REDUCES = ['"sum"', '"mean"', '"count"', '"min"', '"max"']


@pytest.mark.parametrize("apply", APPLIES)
def test_apply_vectorized_matches_jax(data, apply):
    """Every program under one filter form; each answer equal."""
    both, _ = data
    for prog in PROGRAMS:
        assert both.query("i", apply.format(p=prog))[0] == "ok", prog


@pytest.mark.parametrize("apply", ["Apply(All(), {p})", APPLIES[2],
                                   APPLIES[5]])
@pytest.mark.parametrize("reduce", REDUCES)
def test_apply_reduce_matches_jax(data, apply, reduce):
    both, _ = data
    for prog in ('"qty"', '"qty * qty - w"', '"d"', '"f = 1"'):
        assert both.query("i", apply.format(p=f"{prog}, {reduce}"))[0] == \
            "ok", prog


@pytest.mark.parametrize("prog", ['"f = 1"', '"k"', '"f"',
                                  '"coalesce(qty, 0) + 1"',
                                  '"upper(\'a\') || qty"'])
def test_apply_per_record_matches_jax(data, prog):
    """Set, time and keyed fields and function calls take the per-record
    route over Extract's table in both packages."""
    both, _ = data
    assert both.query("i", f"Apply(Intersect(Row(f=1), Row(qty > 1500)), "
                           f"{prog})")[0] == "ok"


def test_apply_routes_agree(data, monkeypatch):
    """With the columnar route turned off in both packages, every program
    and reduce answers as it did on it."""
    both, _ = data
    queries = [f"Apply(Row(f=1), {p})" for p in PROGRAMS[:12]] + \
        [f"Apply(Row(f=2), \"qty\", {r})" for r in REDUCES]
    vec = [both.query("i", q) for q in queries]
    monkeypatch.setattr(Executor, "_apply_vectorized",
                        lambda self, *a, **kw: None)
    monkeypatch.setattr(JaxExecutor, "_apply_vectorized",
                        lambda self, *a, **kw: None)
    assert [both.query("i", q) for q in queries] == vec


def test_apply_past_the_jax_host_decode_switch(data):
    """Shard 0 matches about 72,000 records under Row(qty != null):
    the JAX package decodes that shard's values on the host (n >= 2^16)
    and the others on its device; the port gathers all of them with kernel
    G'''.  The values equal numpy's, in shard then column order."""
    both, r = data
    cols, h = r["cols"], r["qty_has"]
    assert int((h & (cols < SW)).sum()) >= 1 << 16
    (got,) = both.port.query("i", 'Apply(Row(qty != null), "qty * 3")')
    assert got == (r["qty"][h] * 3).tolist()
    assert both.query("i", 'Apply(All(), "qty + 1")')[0] == "ok"
    (got,) = both.port.query("i", 'Apply(All(), "qty + 1")')
    want = [int(v) + 1 if ok else None for v, ok in zip(r["qty"], h)]
    assert got == want


def test_apply_gathers_only_referenced_fields(data, monkeypatch):
    """Each BSI field the program names is gathered by one call of kernel
    G''''s wrapper (one residency batch), and no other field is: the
    wrappers' launch counters stay at 0 on the CPU, so the calls are
    counted around the wrapper; the filter is one kernel-A plan."""
    both, r = data
    calls = {"gather": [], "plan": 0}
    real_gather, real_plan = ck.bsi_decode_gather_sharded, ck.plan_eval

    def gather(groups, cols):
        calls["gather"].append(len(groups))
        return real_gather(groups, cols)

    def plan(*a, **kw):
        calls["plan"] += 1
        return real_plan(*a, **kw)
    monkeypatch.setattr(ck, "bsi_decode_gather_sharded", gather)
    monkeypatch.setattr(ck, "plan_eval", plan)
    for prog, n in (('"qty * 2"', 1), ('"qty + d"', 2), ('"b"', 0),
                    ('"qty + w"', 1), ('"_id"', 0)):
        calls["gather"], calls["plan"] = [], 0
        both.port.query("i", f"Apply(Row(f=1), {prog})")
        assert calls["gather"] == [3] * n, prog
        assert calls["plan"] == 1, prog


@pytest.mark.parametrize("q", ['Apply(All(), "qty +")', "Apply(All())",
                               'Apply(All(), "nope + 1")',
                               'Apply(All(), "qty", "median")',
                               'Apply(All(), "k", "sum")',
                               'Apply(Row(f=1), "qty + f")',
                               'Apply(Row(f=1), "qty", "")'])
def test_apply_errors_match_jax(data, q):
    both, _ = data
    both.query("i", q)


def test_apply_subquery_is_refused(data):
    """A SELECT inside a program needs the SQL planner: both packages
    answer 400, in their own words."""
    both, _ = data
    for api in (both.jax, both.port):
        with pytest.raises(Exception) as e:
            api.query("i", 'Apply(All(), "qty in (select 1)")')
        assert e.value.status == 400


def arrow_data(both, how):
    for shard, lo in ((0, 0), (1, SW), (3, 3 * SW)):
        ids = list(range(lo, lo + 60, 2))
        cols = {"_id": ids, "price": [i * 0.5 for i in range(len(ids))],
                "qty": list(range(len(ids)))}
        if shard == 1:
            cols["name"] = [f"n{i}" for i in range(len(ids))]
        if how == "json":
            both.call("dataframe_ingest", "a", shard, columns=cols)
        else:
            import pyarrow as pa
            import pyarrow.parquet as pq
            buf = io.BytesIO()
            pq.write_table(pa.table(cols), buf)
            both.call("dataframe_ingest", "a", shard,
                      parquet=buf.getvalue())


@pytest.mark.parametrize("how", ["json", "parquet"])
def test_arrow_matches_jax_and_numpy(how):
    both = Both()
    both.call("create_index", "a", {"trackExistence": True})
    both.call("create_field", "a", "f", {"type": "set"})
    both.call("create_field", "a", "v", {"type": "int"})
    assert both.query("a", "Arrow()")[1] == 400     # no dataframe yet
    cols = np.array([4, 6, 7, 10, SW + 2, SW + 8, SW + 9, 3 * SW + 12,
                     2 * SW + 1])
    rows = np.array([1, 1, 2, 1, 1, 2, 1, 1, 1])
    both.call("import_bits", "a", "f", rows, cols)
    both.call("import_values", "a", "v", cols, np.arange(cols.size) * 10)
    arrow_data(both, how)
    for q in ("Arrow()", "Arrow(Row(f=1))", "Arrow(Row(v > 25))",
              "Arrow(Intersect(Row(f=1), Row(v < 60)))",
              "Arrow(Union(Row(f=2), Row(v=null)))",
              "Options(Arrow(Row(f=1)), shards=[1])"):
        assert both.query("a", q)[0] == "ok"
    # the oracle: the f=1 records that have a dataframe row (even ids in
    # the first 60 columns of shards 0, 1 and 3), shard by shard
    (got,) = both.port.query("a", "Arrow(Row(f=1))")
    ids = cols[rows == 1]
    has_row = (ids % 2 == 0) & (ids % SW < 60) & np.isin(ids // SW, [0, 1, 3])
    assert got["columns"]["_id"] == sorted(ids[has_row].tolist())
    assert got["columns"]["qty"] == [(i % SW) // 2 for i in
                                     sorted(ids[has_row].tolist())]
    assert got["headers"] == ["_id", "price", "qty", "name"]


@pytest.fixture()
def lookup():
    both = Both()
    for key, api in (({}, both.jax), ({}, both.port)):
        api.create_index("i")
        api.create_field("i", "f", {"type": "set"})
        api.query("i", "Set(1, f=1) Set(3, f=1) Set(5, f=2) Set(7, f=3)")
        api.create_index("ki", {"keys": True})
        api.create_field("ki", "f", {"type": "set"})
        api.query("ki", 'Set("one", f=1) Set("five", f=1)')
    dbs = []
    for cls, api in ((JaxSQLiteLookup, both.jax), (SQLiteLookup, both.port)):
        db = cls(":memory:")
        conn = db._conn()
        conn.execute("CREATE TABLE ext (id INTEGER PRIMARY KEY, "
                     "name TEXT, score REAL)")
        conn.execute("CREATE TABLE kx (k TEXT PRIMARY KEY, n INTEGER)")
        conn.executemany("INSERT INTO ext VALUES (?, ?, ?)",
                         [(1, "one", 1.5), (3, "three", 3.5),
                          (5, "five", 5.5), (9, "nine", 9.5)])
        conn.executemany("INSERT INTO kx VALUES (?, ?)",
                         [("one", 1), ("five", 5), ("nine", 9)])
        conn.commit()
        api.holder.lookup_db = db
        dbs.append(db)
    return both, dbs


LOOKUPS = [
    'ExternalLookup(Row(f=1), query="SELECT id, name, score FROM ext '
    'WHERE id IN $1 ORDER BY id")',
    'ExternalLookup(Union(Row(f=1), Row(f=2)), query="SELECT id, score '
    'FROM ext WHERE id IN $1 ORDER BY score DESC")',
    'ExternalLookup(Row(f=9), query="SELECT id FROM ext WHERE id IN $1")',
    'ExternalLookup(Row(f=3), query="SELECT id, name FROM ext '
    'WHERE id IN $1")',
    'ExternalLookup(Row(f=1), query="SELECT id FROM ext")',
    'ExternalLookup(Row(f=1))',
    'ExternalLookup(Row(f=1), Row(f=2), query="SELECT 1")',
    'ExternalLookup(Count(Row(f=1)), query="SELECT id FROM ext '
    'WHERE id IN $1")',
]


@pytest.mark.parametrize("q", LOOKUPS)
def test_external_lookup_matches_jax(lookup, q):
    both, _ = lookup
    both.query("i", q)


def test_external_lookup_read_values(lookup):
    both, _ = lookup
    (tbl,) = both.port.query("i", LOOKUPS[0])
    assert [f.name for f in tbl.fields] == ["name", "score"]
    assert [(c.column, c.rows) for c in tbl.columns] == \
        [(1, ["one", 1.5]), (3, ["three", 3.5])]
    (tbl,) = both.port.query("i", LOOKUPS[2])
    assert tbl.columns == []


def test_external_lookup_keyed_and_write(lookup):
    both, dbs = lookup
    both.query("ki", 'ExternalLookup(Row(f=1), query="SELECT k, n FROM kx '
                     'WHERE k IN $1 ORDER BY n")')
    (tbl,) = both.port.query("ki", 'ExternalLookup(Row(f=1), query="SELECT '
                                   'k, n FROM kx WHERE k IN $1 ORDER BY n")')
    assert [(c.column, c.rows) for c in tbl.columns] == \
        [("one", [1]), ("five", [5])]
    both.query("i", 'ExternalLookup(Row(f=2), write=true, '
                    'query="DELETE FROM ext WHERE id IN $1")')
    left = [[r[0] for r in db._conn().execute(
        "SELECT id FROM ext ORDER BY id").fetchall()] for db in dbs]
    assert left[0] == left[1] == [1, 3, 9]


def test_external_lookup_unconfigured_and_dsn(tmp_path):
    both = Both()
    both.call("create_index", "i")
    both.call("create_field", "i", "f", {"type": "set"})
    both.query("i", "Set(1, f=1)")
    got = both.query("i", 'ExternalLookup(Row(f=1), query="SELECT 1")')
    assert got[:2] == ("APIError", 400) and "not configured" in got[2]
    assert isinstance(open_lookup(f"sqlite:{tmp_path}/x.db"), SQLiteLookup)
    assert isinstance(open_lookup(f"{tmp_path}/y.db"), SQLiteLookup)
    with pytest.raises(LookupError_, match="unsupported"):
        open_lookup("postgres://x")
    with pytest.raises(LookupError_, match=r"\$1"):
        SQLiteLookup(":memory:").query("SELECT 1", [1])
