"""Extract, IncludesColumn and FieldValue through both executors.

A seeded Holder built with the JAX package (set, mutex, bool, time, int,
decimal and timestamp fields, a depth-43 int field, keyed set and mutex
fields, and a keyed index) is saved and loaded into the port.  Extract's
filters: All() (the host existence rows), plannable filters (one stacked
plan, fetched once), Limit and filters the plan compiler refuses (the
interpreter, a shard at a time), Options(shards=).  BSI values up to depth
31 come through kernel G' (its plain version here), one launch a shard;
the depth-43 field through the host decode.  Tables must be equal: field
names and types, record ids or keys, and every value (None where a field
has none).  IncludesColumn and FieldValue cover present and absent
columns, each value type, and record keys on the keyed index."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.model.index import IndexOptions as JaxIndexOptions
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import ExecError, Executor
from featurebase_tpu_torch.executor.results import ExtractedTable
from featurebase_tpu_torch.storage import snapshot

N = 1800
KEYS = ["red", "green", "blue"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(rng, idx, cols, keyed_rows: bool):
    n = cols.size
    idx.create_field("f")
    idx.field("f").import_bits(rng.integers(0, 5, n), cols)
    extra = rng.random(n) < 0.3
    idx.field("f").import_bits(rng.integers(0, 5, int(extra.sum())),
                               cols[extra])
    idx.create_field("m", JaxFieldOptions(type="mutex"))
    has_m = rng.random(n) < 0.8
    idx.field("m").import_bits(rng.integers(0, 3, int(has_m.sum())),
                               cols[has_m])
    idx.create_field("b", JaxFieldOptions(type="bool"))
    has_b = rng.random(n) < 0.6
    idx.field("b").import_bits(rng.integers(0, 2, int(has_b.sum())),
                               cols[has_b])
    idx.create_field("t", JaxFieldOptions(type="time", time_quantum="YM"))
    has_t = rng.random(n) < 0.5
    days = rng.integers(0, 60, int(has_t.sum()))
    idx.field("t").import_bits(
        rng.integers(0, 3, int(has_t.sum())), cols[has_t],
        timestamps=[f"2020-{1 + d // 30:02d}-{1 + d % 28:02d}T00:00"
                    for d in days])
    idx.create_field("v", JaxFieldOptions(type="int", min=-500, max=500))
    has_v = rng.random(n) < 0.85
    idx.field("v").import_values(cols[has_v],
                                 rng.integers(-500, 500, int(has_v.sum())))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2,
                                          min=-100, max=100))
    has_d = rng.random(n) < 0.7
    idx.field("d").import_values(
        cols[has_d], np.round(rng.uniform(-100, 100, int(has_d.sum())), 2))
    idx.create_field("ts", JaxFieldOptions(type="timestamp"))
    idx.field("ts").import_values(cols, 1_500_000_000
                                  + rng.integers(0, 1000, n))
    top = (1 << 43) - 1
    idx.create_field("w", JaxFieldOptions(type="int", min=-top, max=top))
    has_w = rng.random(n) < 0.75
    idx.field("w").import_values(
        cols[has_w], rng.integers(-99, 99, int(has_w.sum())) * (1 << 36))
    if keyed_rows:
        idx.create_field("kf", JaxFieldOptions(keys=True))
        idx.create_field("km", JaxFieldOptions(type="mutex", keys=True))
        for name in ("kf", "km"):
            ids = idx.row_translation(name).create_keys(KEYS)
            has = rng.random(n) < 0.8
            idx.field(name).import_bits(
                np.array([ids[KEYS[i]] for i in
                          rng.integers(0, 3, int(has.sum()))]), cols[has])
    idx.mark_exists(cols)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(53)
    holder = JaxHolder()
    build(rng, holder.create_index("x"),
          np.sort(rng.choice(3 * SW, N, replace=False)), True)
    kidx = holder.create_index("kx", JaxIndexOptions(keys=True))
    recs = [f"rec-{i}" for i in range(12)]   # a shard each, about
    ids = kidx.translate_store.create_keys(recs)
    build(rng, kidx, np.array(sorted(ids[r] for r in recs), np.int64), False)
    path = str(tmp_path_factory.mktemp("extract") / "holder")
    jax_snapshot.save(holder, path)
    return JaxExecutor(holder), Executor(snapshot.load(path), device="cpu")


def canon(t):
    return ([(f.name, f.type) for f in t.fields], list(t.col_ids),
            [list(v) for v in t.field_values], t.to_json())


ALL_FIELDS = "Rows(f), Rows(m), Rows(b), Rows(t), Rows(v), Rows(d), " \
    "Rows(ts), Rows(w)"
QUERIES = [
    f"Extract(All(), {ALL_FIELDS}, Rows(kf), Rows(km))",
    f"Extract(Row(f=1), {ALL_FIELDS})",
    f"Extract(Intersect(Row(v > 100), Row(m=2)), {ALL_FIELDS}, Rows(km))",
    f"Extract(Limit(Row(f=2), limit=40, offset=5), {ALL_FIELDS})",
    f"Extract(Union(Row(m=null), Row(b=1)), {ALL_FIELDS}, Rows(kf))",
    "Extract(Row(f=99), Rows(v))",
    "Extract(All())",
    "Extract(ConstRow(columns=[1, 2, 3]), Rows(v), Rows(w))",
    "Options(Extract(Row(f=0), Rows(v), Rows(w), Rows(m)), shards=[2])",
    "Extract(Row(w > 0), Rows(w), Rows(d))",
    "Extract(Limit(Row(f=1), limit=1000), Rows(f), Rows(m), Rows(v))",
]


@pytest.mark.parametrize("query", QUERIES)
def test_extract_matches_jax(engines, query):
    jax_e, port_e = engines
    got = port_e.execute("x", query)[0]
    assert isinstance(got, ExtractedTable)
    assert canon(got) == canon(jax_e.execute("x", query)[0])


@pytest.mark.parametrize("query", [
    f"Extract(All(), {ALL_FIELDS})",
    f"Extract(Row(f=3), {ALL_FIELDS})",
    "Extract(Limit(All(), limit=7), Rows(v), Rows(t))"])
def test_keyed_index_extract_matches_jax(engines, query):
    jax_e, port_e = engines
    got = port_e.execute("kx", query)[0]
    assert canon(got) == canon(jax_e.execute("kx", query)[0])
    assert got.col_ids and all(isinstance(c, str) for c in got.col_ids)


def test_extract_needs_a_filter(engines):
    _, port_e = engines
    with pytest.raises(ExecError, match="filter"):
        port_e.execute("x", "Extract(TopN(f, n=2), Rows(f))")


@pytest.fixture(scope="module")
def some_cols(engines):
    jax_e, _ = engines
    cols = jax_e.execute("x", "Row(f=1)")[0].columns()
    return [int(cols[0]), int(cols[-1]), int(cols[len(cols) // 2])]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("field", ["v", "d", "ts", "w"])
def test_field_value_matches_jax(engines, some_cols, which, field):
    jax_e, port_e = engines
    q = f"FieldValue(field={field}, column={some_cols[which]})"
    got, want = port_e.execute("x", q)[0], jax_e.execute("x", q)[0]
    assert (got.val, got.count, got.float_val, got.timestamp_val) == \
        (want.val, want.count, want.float_val, want.timestamp_val)


@pytest.mark.parametrize("q", [
    "FieldValue(field=v, column=7)",
    "FieldValue(field=v, column=99999999)",
    "FieldValue(field=n, column='missing')"])
def test_field_value_of_a_column_without_one(engines, q):
    jax_e, port_e = engines
    index = "kx" if "missing" in q else "x"
    if "field=n" in q:
        q = q.replace("field=n", "field=v")
    got, want = port_e.execute(index, q)[0], jax_e.execute(index, q)[0]
    assert (got.val, got.count) == (want.val, want.count) == (0, 0)


def test_field_value_by_record_key(engines):
    jax_e, port_e = engines
    for rec in ("rec-0", "rec-5", "rec-11"):
        q = f"FieldValue(field=v, column='{rec}')"
        got, want = port_e.execute("kx", q)[0], jax_e.execute("kx", q)[0]
        assert (got.val, got.count) == (want.val, want.count)


@pytest.mark.parametrize("call", [
    "Row(f=1)", "Row(v > 0)", "Union(Row(m=null), Row(b=0))",
    "Distinct(field=v)"])
def test_includes_column_matches_jax(engines, some_cols, call):
    jax_e, port_e = engines
    for c in [*some_cols, 3, 2 * SW + 11]:
        q = f"IncludesColumn({call}, column={c})"
        assert port_e.execute("x", q)[0] is jax_e.execute("x", q)[0]


def test_includes_column_by_record_key(engines):
    jax_e, port_e = engines
    for rec in ("rec-3", "rec-10", "nobody"):
        q = f"IncludesColumn(All(), column='{rec}')"
        assert port_e.execute("kx", q)[0] is jax_e.execute("kx", q)[0]


def test_reference_extract_and_includes_column_cases(tmp_path):
    """tests/test_executor.py's test_extract and test_includes_column,
    their data written with the JAX executor's PQL, through both
    executors, with the answers that file asserts."""
    holder = JaxHolder()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("n", JaxFieldOptions(type="int", min=0, max=100))
    jax_e = JaxExecutor(holder)
    jax_e.execute("i", "Set(1, f=1) Set(1, f=2) Set(2, f=1) Set(1, n=42) "
                       "Set(2, n=7) Set(3, f=2)")
    path = str(tmp_path / "holder")
    jax_snapshot.save(holder, path)
    port_e = Executor(snapshot.load(path), device="cpu")
    q = "Extract(All(), Rows(f), Rows(n))"
    got = port_e.execute("i", q)[0]
    assert canon(got) == canon(jax_e.execute("i", q)[0])
    cols = {c.column: c.rows for c in got.columns}
    assert cols[1] == [[1, 2], 42] and cols[2] == [[1], 7]
    assert cols[3] == [[2], None]
    for c, want in ((2, True), (4, False), (3, False)):
        q = f"IncludesColumn(Row(f=1), column={c})"
        assert port_e.execute("i", q)[0] is want is \
            jax_e.execute("i", q)[0]
