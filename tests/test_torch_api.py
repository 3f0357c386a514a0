"""The port's API (featurebase_tpu_torch.server.api) against the JAX
package's, call by call.

Both APIs are driven with the same calls from an empty holder: the PQL
corpus of tests/test_acceptance_pql2.py (its case lists imported, each
case its own test), the queries of its other tests and its write flows
(Store, ClearRow, Delete, time quanta, keyed indexes), schema operations and
their error statuses, the safety rails (max_writes_per_request,
max_query_memory, query_timeout), status and fragments_info, and the
device rule.  Every answer must be equal, exactly: the corpus holds no
float but Percentile on a decimal field, which both packages compute by
the same bisection over the same stored integers."""
import numpy as np
import pytest
import torch

import test_acceptance_pql2 as pql2
from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu.server.api import APIError as JaxAPIError
from featurebase_tpu_torch.server.api import API, APIError


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon(r):
    """A comparable form of an answer of either package."""
    name = type(r).__name__
    if hasattr(r, "to_info"):          # an Index or a Field
        return ("info", r.to_info())
    if name == "IDRange":
        return ("ids", r.to_json())
    if name == "SignedRow":
        return ("signed", r.values().tolist())
    if hasattr(r, "segments"):
        return ("row", r.columns().tolist(), r.keys)
    if hasattr(r, "pairs"):
        return ("pairs", r.field, [(p.id, p.count, p.key) for p in r.pairs])
    if hasattr(r, "pair"):
        return ("pair", r.field, r.pair.id, r.pair.count, r.pair.key)
    if hasattr(r, "val"):
        return ("valcount", r.val, r.count, r.float_val, r.decimal_val,
                r.timestamp_val)
    if name == "ExtractedTable":
        return ("table", [(f.name, f.type) for f in r.fields],
                [(c.column, list(c.rows)) for c in r.columns])
    if isinstance(r, list):
        return [(tuple((fr.field, fr.row_id, fr.row_key, fr.value)
                       for fr in x.group), x.count, x.agg)
                if hasattr(x, "group") else canon(x) for x in r]
    if isinstance(r, dict):
        return {k: canon(v) for k, v in r.items()}
    if isinstance(r, np.integer):
        return int(r)
    if isinstance(r, np.floating):
        return float(r)
    return r


class Both:
    """The JAX API and the port's (device="cpu"), driven together."""

    def __init__(self, **kw):
        self.jax = JaxAPI(**kw)
        self.port = API(device="cpu", **kw)

    def call(self, method, *args, **kw):
        """Run one API method on both; equal answers, or the same error
        status and message."""
        out = []
        for api, err_type in ((self.jax, JaxAPIError), (self.port, APIError)):
            try:
                out.append(("ok", canon(getattr(api, method)(*args, **kw))))
            except err_type as e:
                out.append(("APIError", e.status, str(e)))
            except AssertionError:
                raise
            except Exception as e:  # noqa: BLE001 — compared across packages
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], (method, args, out)
        return out[1]

    def query(self, index, pql):
        return self.call("query", index, pql)


def seed_pql2(both):
    """The data of tests/test_acceptance_pql2.py's `api` fixture."""
    both.call("create_index", "i", {"trackExistence": True})
    both.call("create_field", "i", "f", {"type": "set"})
    both.call("create_field", "i", "g", {"type": "set"})
    both.call("create_field", "i", "v", {"type": "int"})
    cols = [1, 2, 7, SW + 3, 2 * SW + 5]
    both.call("import_bits", "i", "f", [1, 1, 10, 2, 3], cols)
    both.call("import_bits", "i", "g", [0, 1, 0, 0, 1], cols)
    both.call("import_values", "i", "v", cols, [10, 20, 50, 30, 40])


@pytest.fixture(scope="module")
def corpus():
    both = Both()
    seed_pql2(both)
    return both


def plain(r):
    """The corpus's expected form of an answer (tests/test_acceptance_pql2
    compares row ids, columns and values)."""
    if hasattr(r, "segments"):
        return list(r.columns())
    if isinstance(r, list):
        return [getattr(x, "row_id", x) for x in r]
    return r


@pytest.mark.parametrize("pql,want", pql2.ROWS_CASES + pql2.BITMAP_CASES +
                         pql2.SCALAR_CASES,
                         ids=[c[0][:44] for c in pql2.ROWS_CASES +
                              pql2.BITMAP_CASES + pql2.SCALAR_CASES])
def test_corpus_cases(corpus, pql, want):
    assert corpus.query("i", pql)[0] == "ok"
    (got,) = corpus.port.query("i", pql)
    assert plain(got) == want


# the queries of test_acceptance_pql2.py's other tests over its `api` data
CORPUS_QUERIES = [
    "FieldValue(field=v, column=7)",
    "FieldValue(field=v, column=999)",
    "MinRow(field=f)",
    "MaxRow(field=f)",
    "GroupBy(Rows(f), limit=2)",
    "GroupBy(Rows(f), having=Condition(count > 1))",
    'GroupBy(Rows(f), sort="count desc")',
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(g), aggregate=Sum(field=v))",
    "TopN(f, n=2, filter=Row(g=0))",
    "TopK(f, k=1)",
    "TopN(f)",
    "Count(Distinct(Row(g=0), field=f))",
    "Distinct(Row(g=1), field=v)",
    "Sort(Row(g=0), field=v, limit=2)",
    "Sort(All(), field=v, limit=2, sort-desc=true)",
    "Extract(Limit(All(), limit=2), Rows(v))",
    "Options(Count(Row(f=1)), shards=[0])",
    "Options(Count(Row(f=1)), shards=[1, 2])",
    "Options(Count(All()), shards=[2])",
    "Options(Count(All()), shards=[0, 1, 2])",
    "Options(Count(All()), shards=[7])",
    "Count(Row(f=1)) TopN(g) Sum(field=v) Min(Row(g=1), field=v)",
]


@pytest.mark.parametrize("pql", CORPUS_QUERIES)
def test_corpus_queries(corpus, pql):
    assert corpus.query("i", pql)[0] == "ok"


def _store_flow(both):
    both.call("create_index", "w", {"trackExistence": True})
    both.call("create_field", "w", "f", {"type": "set"})
    both.call("create_field", "w", "g", {"type": "set"})
    both.call("import_bits", "w", "f", [1, 1, 2], [1, 2, SW + 3])
    return "w", ["Store(Row(f=1), g=9)", "Count(Row(g=9))",
                 "Store(Row(f=2), g=9)", "Row(g=9)", "ClearRow(g=9)",
                 "Count(Row(g=9))", "Count(All())", "Delete(Row(f=1))",
                 "Count(All())", "Count(Row(f=1))", "Count(Row(f=2))"]


def _time_flow(both):
    both.call("create_index", "t", {"trackExistence": True})
    both.call("create_field", "t", "e", {"type": "time",
                                         "timeQuantum": "YMD"})
    both.call("import_bits", "t", "e", [1, 1, 2], [10, 20, 30],
              timestamps=["2020-01-15T00:00:00Z", "2020-03-02T00:00:00Z",
                          "2020-01-20T00:00:00Z"])
    return "t", ["Row(e=1, from='2020-01-01T00:00:00Z', "
                 "to='2020-02-01T00:00:00Z')", "Row(e=1)",
                 "Rows(e, from='2020-01-01T00:00:00Z', "
                 "to='2020-02-01T00:00:00Z')",
                 "Rows(e, from='2020-02-01T00:00:00Z', "
                 "to='2020-04-01T00:00:00Z')"]


def _keyed_flow(both):
    both.call("create_index", "k", {"keys": True, "trackExistence": True})
    both.call("create_field", "k", "kf", {"type": "set", "keys": True})
    both.call("import_bits", "k", "kf", row_keys=["alpha", "alpha", "beta"],
              col_keys=["u1", "u2", "u3"], rows=None, cols=None)
    return "k", ['Count(Row(kf="alpha"))', 'Set("u9", kf="alpha")',
                 'Count(Row(kf="alpha"))', "TopN(kf, n=2)", "Rows(kf)",
                 "Extract(All(), Rows(kf))", 'Delete(Row(kf="beta"))',
                 'Count(Row(kf="beta"))', "Count(All())",
                 'Count(ConstRow(columns=["u1", "u2"]))',
                 'Count(ConstRow(columns=["missing"]))',
                 'IncludesColumn(Row(kf="alpha"), column="u1")',
                 'Rows(kf, column="u2")']


def _keyed_sort_flow(both):
    both.call("create_index", "ks", {"keys": True, "trackExistence": True})
    both.call("create_field", "ks", "v", {"type": "int"})
    both.call("import_values", "ks", "v", cols=None, values=[30, 10, 20],
              col_keys=["c", "a", "b"])
    return "ks", ["Sort(All(), field=v, limit=3)"]


def _decimal_flow(both):
    both.call("create_index", "dp", {"trackExistence": True})
    both.call("create_field", "dp", "d", {"type": "decimal", "scale": 2})
    both.call("import_values", "dp", "d", [1, 2, 3, 4, 5, 6],
              [10.0, 10.0, 11.0, 12.0, 12.0, 13.0])
    return "dp", ["Percentile(field=d, nth=50)", "Sum(field=d)",
                  "Max(field=d)"]


def _count_distinct_flow(both):
    both.call("create_index", "gcd", {"trackExistence": True})
    both.call("create_field", "gcd", "f", {"type": "set"})
    both.call("create_field", "gcd", "v", {"type": "int"})
    both.call("import_bits", "gcd", "f", [1, 1, 1, 2], [1, 2, 3, 4])
    both.call("import_values", "gcd", "v", [1, 2, 3, 4], [5, 10, 5, 15])
    return "gcd", ["GroupBy(Rows(f), aggregate=Count(Distinct(field=v)))",
                   "GroupBy(Rows(f), filter=Row(v > 9), "
                   "aggregate=Count(Distinct(field=v)))"]


def _range_flow(both):
    both.call("create_index", "rng", {"trackExistence": True})
    both.call("create_field", "rng", "v", {"type": "int", "min": 0,
                                           "max": 100})
    both.call("import_values", "rng", "v", [1, 2], [50, 101])
    both.call("import_values", "rng", "v", [2], [0])
    both.call("create_field", "rng", "u", {"type": "int"})
    both.call("create_field", "rng", "s", {"type": "set"})
    return "rng", ["Set(1, v=500)", "Set(1, v=-5)", "Set(1, v=100)",
                   "Set(1, u=123456789)", "Sum(field=u)", 'Row(s="nope")',
                   "Count(Row(", "Count(Row(nope=1))"]


FLOWS = [_store_flow, _time_flow, _keyed_flow, _keyed_sort_flow,
         _decimal_flow, _count_distinct_flow, _range_flow]


@pytest.mark.parametrize("flow", FLOWS, ids=[f.__name__[1:] for f in FLOWS])
def test_write_and_keyed_flows(flow):
    """tests/test_acceptance_pql2.py's flows through both APIs: each
    query's answer, or its error status and message, equal."""
    both = Both()
    index, queries = flow(both)
    for q in queries:
        both.query(index, q)


def test_import_errors_match():
    both = Both()
    both.call("create_index", "rng", {})
    both.call("create_field", "rng", "v", {"type": "int", "min": 0,
                                           "max": 100})
    both.call("create_field", "rng", "s", {"type": "set"})
    for method, args in (("import_values", ("rng", "s", [1], [2])),
                         ("import_values", ("rng", "nope", [1], [2])),
                         ("import_bits", ("rng", "nope", [1], [2])),
                         ("import_bits", ("nope", "s", [1], [2])),
                         ("create_field_keys", ("rng", "s", ["a"]))):
        assert both.call(method, *args)[0] == "APIError"
    got = both.call("import_values", "rng", "v", [1, 2], [50, 101])
    assert got[0] == "ValueError" and "maximum" in got[1]
    both.call("import_values", "rng", "v", [3], [0])
    both.query("rng", "Sum(field=v)")


BAD_FIELD_OPTIONS = [
    {"type": "int", "min": 10, "max": 5},
    {"type": "set", "cacheType": "nope"},
    {"type": "decimal", "scale": -1},
    {"type": "decimal", "scale": 20},
    {"type": "time", "timeQuantum": "YD"},
    {"type": "time", "timeQuantum": "XB"},
    {"type": "time", "ttl": 60},
    {"type": "set", "foreignIndex": "nope"},
]


def test_schema_operations_and_statuses():
    both = Both()
    assert both.call("create_index", "i", {"keys": False})[0] == "ok"
    assert both.call("create_index", "i")[1] == 409
    assert both.call("create_index", "i", None, True)[0] == "ok"
    assert both.call("delete_index", "nope")[1] == 404
    assert both.call("create_field", "nope", "f")[1] == 404
    both.call("create_field", "i", "f", {"type": "set"})
    assert both.call("create_field", "i", "f")[1] == 409
    both.call("create_field", "i", "f", None, True)
    for opts in BAD_FIELD_OPTIONS:
        assert both.call("create_field", "i", "bad", opts)[1] == 400
    for name, opts in (("ok1", {"type": "int", "min": 0, "max": 10}),
                       ("ok2", {"type": "time", "timeQuantum": "MDH",
                                "ttl": 60}),
                       ("ok3", {"type": "set", "cacheType": "none"}),
                       ("d", {"type": "decimal", "scale": 2}),
                       ("m", {"type": "mutex", "keys": True})):
        both.call("create_field", "i", name, opts)
    assert both.call("delete_field", "i", "nope")[1] == 404
    assert both.call("delete_field", "nope", "f")[1] == 404
    both.call("delete_field", "i", "ok1")
    both.call("create_sql_view", "v1", "SELECT * FROM i")
    assert both.call("create_sql_view", "v1", "SELECT 1")[1] == 409
    assert both.call("delete_sql_view", "nope")[1] == 404
    both.call("delete_sql_view", "nope", if_exists=True)
    assert both.port.holder.sql_views == both.jax.holder.sql_views
    both.call("schema")
    both.call("apply_schema", [{"name": "j", "options": {},
                                "fields": [{"name": "x", "options":
                                            {"type": "int"}}]}])
    both.call("schema")
    assert both.query("i", "Count(Row(f=1)")[1] == 400
    assert both.query("nope", "Count(All())")[1] == 404
    assert both.query("i", "Count(Row(nope=1))")[1] == 400
    both.call("delete_index", "j")
    both.call("schema")
    assert both.call("available_shards", "i")[0] == "ok"


def test_id_allocation_matches():
    both = Both()
    both.call("create_index", "i")
    for args in (("i", "k", "s1", 0, 10), ("i", "k", "s1", 0, 10),
                 ("i", "k", "s2", 1, 5)):
        got = both.call("reserve_ids", *args)
        assert got[0] == "ok"
    both.call("commit_ids", "i", "k", "s2", 1, 5)
    assert both.call("commit_ids", "i", "k", "s9", 1, 5)[1] == 409
    assert both.call("reserve_ids", "i", "k", "s2", 0, 3)[1] == 409
    assert [r.to_json() for r in both.port.reserve_ids("i", "q", "s", 0, 4)
            ] == [r.to_json() for r in
                  both.jax.reserve_ids("i", "q", "s", 0, 4)]


def test_atomic_records_and_mutex_check():
    both = Both()
    both.call("create_index", "i")
    both.call("create_field", "i", "f", {"type": "set"})
    both.call("create_field", "i", "m", {"type": "mutex"})
    both.call("create_field", "i", "v", {"type": "int"})
    both.call("import_atomic_record", "i", [
        {"col": 1, "sets": {"f": [1, 2], "m": 3}, "values": {"v": 7}},
        {"col": SW + 4, "sets": {"f": 2}, "values": {"v": -3}}])
    assert both.call("import_atomic_record", "i",
                     [{"col": 5, "values": {"f": 1}}])[1] == 400
    assert both.call("import_atomic_record", "i",
                     [{"col": 5, "sets": {"v": 1}}])[1] == 400
    assert both.call("import_atomic_record", "i", [{"sets": {}}])[1] == 400
    for q in ("Row(f=2)", "Sum(field=v)", "Row(m=3)"):
        both.query("i", q)
    # break the mutex invariant below the API, in both holders
    for api in (both.jax, both.port):
        api.holder.index("i").field("m").standard_view().fragment(0) \
            .set_bit(4, 1)
    both.call("mutex_check", "i", "m")
    assert both.call("mutex_check", "i", "f")[1] == 400
    for shard in (0, 1, 2):
        got = both.port.shard_fragment_checksums("i", shard)
        want = both.jax.shard_fragment_checksums("i", shard)
        assert got["fragments"] == want["fragments"]
    both.call("recalculate_caches")
    both.query("i", "TopN(f)")


def test_max_writes_per_request():
    both = Both(max_writes_per_request=1)
    both.call("create_index", "t3")
    both.call("create_field", "t3", "f", {"type": "set"})
    got = both.query("t3", "Set(1, f=1) Clear(1, f=1)")
    assert got[:2] == ("APIError", 400) and "max-writes" in got[2]
    assert both.query("t3", "Set(1, f=1)")[0] == "ok"


def test_max_query_memory():
    """tests/test_safety_rails.py's cases: the same rejection, in the same
    words, from both packages."""
    both = Both(max_query_memory=1 << 20)
    both.call("create_index", "i")
    both.call("create_field", "i", "f", {"type": "set"})
    for s in range(4):
        both.query("i", f"Set({s * SW + 1}, f={s})")
    got = both.query("i", "TopN(f)")
    assert got[:2] == ("APIError", 400) and "max-query-memory" in got[2]
    assert both.query("i", "Count(Row(f=0))") == ("ok", [1])
    both = Both(max_query_memory=3 << 20)
    both.call("create_index", "i")
    both.call("create_field", "i", "v", {"type": "int", "min": 0,
                                         "max": 100})
    cols = list(range(150_000))
    both.call("import_values", "i", "v", cols, [c % 100 for c in cols])
    for q in ("Sort(All(), field=v)", "Extract(All(), Rows(v))"):
        got = both.query("i", q)
        assert got[:2] == ("APIError", 400) and "max-query-memory" in got[2]
    assert both.query("i", "Extract(Limit(All(), limit=3), Rows(v))")[0] \
        == "ok"
    assert both.query("i", "Sort(All(), field=v, limit=5)")[0] == "ok"


def test_query_timeout_is_408():
    both = Both(query_timeout=-1.0)   # already expired
    both.call("create_index", "i")
    both.call("create_field", "i", "f", {"type": "set"})
    got = both.query("i", "Count(Row(f=1))")
    assert got[:2] == ("APIError", 408)


def test_profile_and_tracker():
    both = Both()
    seed_pql2(both)
    for api in (both.jax, both.port):
        out = api.query_full("i", "Options(Count(Row(f=1)), profile=true)")
        assert out["results"] == [2]
        assert out["profile"]["name"] == "query"
        api.query("i", "Count(All())")
        hist = api.tracker.past()
        assert [h["PQL"] for h in hist[:2]] == [
            "Count(All())", "Options(Count(Row(f=1)), profile=true)"]


def test_status_and_fragments_info_keys(corpus):
    port, jax = corpus.port.status(), corpus.jax.status()
    assert set(port) == set(jax)
    assert port["indexes"] == jax["indexes"] and port["devices"] == ["cpu"]
    assert port["shardWidth"] == jax["shardWidth"]
    corpus.port.query("i", "Count(Row(f=1))")
    got = corpus.port.fragments_info("i")
    want = corpus.jax.fragments_info("i")
    assert [set(r) for r in got] == [set(r) for r in want]
    key = ("field", "view", "shard", "rows", "hostBytes", "spilled")
    assert [tuple(r[k] for k in key) for r in got] == \
        [tuple(r[k] for k in key) for r in want]


def test_device_rule():
    """API() runs on CUDA and raises without it; API(mesh=) runs over the
    mesh's members (make_mesh() wants CUDA too); API(cluster=) runs the
    DistributedExecutor on the device it is given."""
    from featurebase_tpu_torch.parallel.mesh import make_mesh
    if torch.cuda.is_available():
        assert API().executor.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            API()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
    mapi = API(mesh=make_mesh(devices=["cpu"] * 2))
    assert mapi.executor.mesh.size == 2
    assert mapi.status()["devices"] == ["cpu", "cpu"]
    mapi.create_index("i")
    mapi.create_field("i", "f")
    mapi.import_bits("i", "f", [1, 1, 2], [1, 5 << 20, 3])
    assert mapi.query("i", "Count(Row(f=1))") == [2]
    from featurebase_tpu_torch.cluster.cluster import Cluster
    capi = API(device="cpu", cluster=Cluster(
        "node0", [{"id": "node0", "uri": "http://127.0.0.1:1"}]))
    assert capi.distributed is not None
    assert capi.executor.device.type == "cpu"
    assert capi.status()["nodeID"] == "node0"
    api = API(device="cpu")
    assert api.executor.device.type == "cpu"
    with pytest.raises(APIError, match="index not found"):
        api.import_roaring("i", "f", 0, b"")   # roaring runs (item 13)
    assert api.resync_shards() == 0   # no cluster, nothing to pull
