"""PQL writes (Set, Clear, ClearRow, Store, Delete) through both
executors, and the reads after them.

Holders are built with the JAX package from a numpy seed, saved and loaded
into the port, so both start from identical bits.  Reads first fill the
port's device caches (the plan executor's leaves, its stacked decode
``stacked_vals``, the TopN rank cache and the fragment mirrors); then the
same write sequence goes through both executors, each write's answer
equal; then a battery of reads must answer equally in both, and equal to
the answers of a port executor whose caches were never filled.  The
sequence covers set, mutex, bool, time (with a timestamp), int and decimal
fields, an out-of-range value (ExecError in both), Clear of an absent value,
Store into a new row and over an existing one, ClearRow, Delete, and writes
on a keyed index (created keys; Delete drops the deleted records' keys)."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import ExecError as JaxExecError
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.model.index import IndexOptions as JaxIndexOptions
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import ExecError, Executor
from featurebase_tpu_torch.storage import snapshot

N = 1500


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon(r):
    """A comparable form of an answer of either package."""
    if type(r).__name__ == "SignedRow":
        return ("signed", r.values().tolist())
    if hasattr(r, "segments"):
        return ("row", r.columns().tolist(), r.keys)
    if hasattr(r, "pairs"):
        return ("pairs", [(p.id, p.count, p.key) for p in r.pairs])
    if hasattr(r, "pair"):
        return ("pair", r.pair.id, r.pair.count)
    if hasattr(r, "val"):
        return ("valcount", r.val, r.count)
    if hasattr(r, "col_ids"):
        return ("table", list(r.col_ids), [list(v) for v in r.field_values])
    if isinstance(r, list) and r and hasattr(r[0], "group"):
        return [(tuple((fr.field, fr.row_id, fr.row_key) for fr in gc.group),
                 gc.count, gc.agg) for gc in r]
    if isinstance(r, dict):
        return ("sort", list(r["columns"]), list(r["values"]))
    if isinstance(r, (np.integer,)):
        return int(r)
    return r


def build(tmp_path_factory):
    rng = np.random.default_rng(77)
    cols = np.sort(rng.choice(3 * SW, N, replace=False)).astype(np.int64)
    holder = JaxHolder()
    idx = holder.create_index("w")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("m", JaxFieldOptions(type="mutex"))
    idx.create_field("b", JaxFieldOptions(type="bool"))
    idx.create_field("t", JaxFieldOptions(type="time", time_quantum="YMD"))
    idx.create_field("v", JaxFieldOptions(type="int", min=-300, max=900))
    idx.create_field("u", JaxFieldOptions(type="int", min=-500, max=4000))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2, min=-50,
                                          max=50))
    idx.field("f").import_bits(rng.integers(0, 6, N), cols)
    idx.field("g").import_bits(rng.integers(0, 3, N), cols)
    idx.field("m").import_bits(rng.integers(0, 4, N), cols)
    idx.field("b").import_bits(rng.integers(0, 2, N), cols)
    v = rng.integers(-300, 900, N)
    v[:40] = 42
    idx.field("v").import_values(cols, v)
    some = rng.random(N) < 0.7
    idx.field("u").import_values(
        cols[some], np.clip(2 * v[some] + rng.integers(-200, 200,
                                                       int(some.sum())),
                            -500, 4000))
    idx.field("d").import_values(cols[::4], rng.integers(-4000, 4000,
                                                         cols[::4].size)
                                 / 100.0)
    idx.mark_exists(cols)
    keyed = holder.create_index("k", JaxIndexOptions(keys=True))
    keyed.create_field("kf", JaxFieldOptions(keys=True))
    keyed.create_field("s")
    keyed.create_field("n", JaxFieldOptions(type="int", min=0, max=1000))
    ids = keyed.translate_store.create_keys([f"r{i}" for i in range(10)])
    kc = np.array(sorted(ids.values()), dtype=np.int64)
    kid = keyed.row_translation("kf").create_keys(["alpha", "beta"])
    keyed.field("kf").import_bits(
        np.array([kid["alpha"] if i % 2 else kid["beta"]
                  for i in range(kc.size)]), kc)
    keyed.field("s").import_bits(rng.integers(0, 3, kc.size), kc)
    keyed.field("n").import_values(kc, rng.integers(0, 1000, kc.size))
    keyed.mark_exists(kc)
    path = str(tmp_path_factory.mktemp("writes") / "holder")
    jax_snapshot.save(holder, path)
    return JaxExecutor(holder), Executor(snapshot.load(path), device="cpu"), \
        path, cols


# reads that fill the port's caches before the writes, and the battery
# after them
READS = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Row(v > 100))",
    "Count(Row(v == 42))",
    "Count(All())",
    "Count(Not(Row(f=9)))",
    "Row(f=9)",
    "Row(t=3, from=2018-01-01T00:00, to=2019-01-01T00:00)",
    "TopN(f)",
    "TopN(f, n=3)",
    "TopN(m)",
    "TopN(f, Row(g=1), n=4)",
    "Sum(field=v)",
    "Sum(Row(f=2), field=v)",
    "Sum(field=d)",
    "Min(field=v)",
    "Max(Row(g=0), field=v)",
    "Min(Union(Row(g=1), Row(f=null)), field=v)",
    "MinRow(field=f)",
    "MaxRow(field=f)",
    "Rows(f)",
    "Rows(m)",
    "Rows(b)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), aggregate=Sum(field=v))",
    "GroupBy(Rows(b))",
    "Distinct(field=v)",
    "Distinct(Row(f=1), field=g)",
    "Percentile(field=v, nth=50)",
    "Sort(Row(f=1), field=v, limit=7)",
    "Extract(Limit(Row(f=9), limit=20), Rows(f), Rows(v), Rows(m))",
    "Var(field=v)",
    "Var(field=v, filter=Row(f=1))",
    "Corr(field=v, field2=u)",
    "Corr(field=v, field2=u, filter=Row(g=2))",
    "Var(field=d)",
]
KEYED_READS = [
    "Row(s=1)",
    "Count(All())",
    "TopN(kf)",
    "Rows(kf)",
    "Extract(All(), Rows(kf), Rows(n))",
    "Sum(field=n)",
    "Var(field=n)",
]


def writes(cols):
    """(index, query) of the write sequence."""
    c = [int(x) for x in cols]
    new_shard = 4 * SW + 9
    return [
        ("w", f"Set({c[0]}, f=1)"),              # already set: False
        ("w", f"Set({c[1]}, f=5)"),
        ("w", f"Set({new_shard}, f=1)"),        # a new shard
        ("w", f"Set({c[2]}, m=3)"),
        ("w", f"Set({c[3]}, b=true)"),
        ("w", f"Set({c[4]}, b=false)"),
        ("w", f"Set({c[5]}, t=3, 2018-08-01T12:00)"),
        ("w", f"Set({c[6]}, v=123)"),
        ("w", f"Set({new_shard}, v=-7)"),
        ("w", f"Set({c[7]}, v=42)"),
        ("w", f"Set({c[8]}, u=3999)"),
        ("w", f"Set({c[9]}, d=12.5)"),
        ("w", f"Set({c[10]}, v=99999)"),         # out of range
        ("w", f"Clear({c[11]}, f=0)"),
        ("w", f"Clear({c[11]}, f=1)"),
        ("w", f"Clear({c[12]}, v=0)"),
        ("w", f"Clear({new_shard + 1}, v=0)"),   # no value there
        ("w", f"Clear({c[13]}, d=0)"),
        ("w", "ClearRow(f=4)"),
        ("w", "ClearRow(f=77)"),
        ("w", "Store(Intersect(Row(f=1), Row(g=2)), f=9)"),
        ("w", "Store(Row(g=0), f=3)"),
        ("w", "Delete(Row(v == 42))"),
        ("w", "Delete(Row(f=88))"),
        ("w", f"Set({c[14]}, f=1) Set({c[15]}, v=-299)"),
        ("k", 'Set("new", s=1)'),
        ("k", 'Set("r3", kf="gamma")'),
        ("k", 'Set("r4", n=77)'),
        ("k", "Delete(Row(s=2))"),
        ("k", 'Clear("r5", s=1)'),
    ]


def both(jax_e, port_e, index, q):
    """Each package's answers to one query, or the error class each
    raised."""
    out = []
    for e, err in ((jax_e, JaxExecError), (port_e, ExecError)):
        try:
            out.append([canon(r) for r in e.execute(index, q)])
        except err as x:
            out.append(("ExecError", str(x)))
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both executors after the reads, then the writes; the write answers
    of both; and a port executor over the snapshot taken before the writes
    (for the out-of-range check)."""
    jax_e, port_e, path, cols = build(tmp_path_factory)
    port_before = {}
    for q in READS:
        port_before[q] = [canon(r) for r in port_e.execute("w", q)]
    for q in KEYED_READS:
        port_e.execute("k", q)
    f = port_e.holder.index("w").field("f")
    assert f._topn_cache and port_e.plan_executor._leaf_cache
    assert any(k[0] == "vals" for k in port_e.plan_executor._leaf_cache)
    answers = [(index, q, *both(jax_e, port_e, index, q))
               for index, q in writes(cols)]
    return jax_e, port_e, answers, port_before


def test_write_answers_match_jax(written):
    _, _, answers, _ = written
    for index, q, jax_a, port_a in answers:
        assert port_a == jax_a, (index, q)
    by_q = {q: port_a for _, q, _, port_a in answers}
    assert by_q[next(q for q in by_q if q.endswith("v=99999)"))][0] == \
        "ExecError"
    assert by_q["ClearRow(f=4)"] == [True]
    assert by_q["ClearRow(f=77)"] == [False]
    assert by_q["Delete(Row(f=88))"] == [False]
    assert by_q["Delete(Row(v == 42))"] == [True]
    assert by_q[next(q for q in by_q if q.endswith(", v=0)")
                     and str(4 * SW + 10) in q)] == [False]


@pytest.mark.parametrize("q", READS)
def test_reads_after_writes_match_jax(written, q):
    jax_e, port_e, _, before = written
    got = [canon(r) for r in port_e.execute("w", q)]
    assert got == [canon(r) for r in jax_e.execute("w", q)]
    fresh = Executor(port_e.holder, device="cpu")
    assert [canon(r) for r in fresh.execute("w", q)] == got


@pytest.mark.parametrize("q", KEYED_READS)
def test_keyed_reads_after_writes_match_jax(written, q):
    jax_e, port_e, _, _ = written
    assert [canon(r) for r in port_e.execute("k", q)] == \
        [canon(r) for r in jax_e.execute("k", q)]


def test_writes_changed_what_the_caches_held(written):
    """The reads after the writes differ from the cached answers before
    them where the writes reach (so the equalities above are not those of
    unchanged data)."""
    _, port_e, _, before = written
    changed = [q for q in ("Count(Row(f=1))", "Row(f=9)", "TopN(f)",
                           "Sum(field=v)", "Distinct(field=v)",
                           "Var(field=v)", "Corr(field=v, field2=u)",
                           "GroupBy(Rows(f), Rows(g))")
               if [canon(r) for r in port_e.execute("w", q)] != before[q]]
    assert len(changed) == 8, changed


def test_delete_drops_keys(written):
    jax_e, port_e, _, _ = written
    for e in (jax_e, port_e):
        store = e.holder.index("k").translate_store
        found = store.find_keys([f"r{i}" for i in range(10)] + ["new"])
        jax_found = jax_e.holder.index("k").translate_store.find_keys(
            [f"r{i}" for i in range(10)] + ["new"])
        assert found == jax_found
    assert "new" in port_e.holder.index("k").translate_store.find_keys(
        ["new"])
    gone = set(f"r{i}" for i in range(10)) - set(
        port_e.holder.index("k").translate_store.find_keys(
            [f"r{i}" for i in range(10)]))
    assert gone


def test_write_query_takes_the_gate_not_a_pin(tmp_path_factory,
                                              monkeypatch):
    """A query that writes runs under the index's mutate gate, with no
    snapshot pin; a read pins."""
    from featurebase_tpu_torch.model import snapshot as port_snapshot
    _, port_e, _, cols = build(tmp_path_factory)
    idx = port_e.holder.index("w")
    seen = []
    real_shared = idx.mutate_gate.shared
    real_pin = port_snapshot.pin_index

    def shared():
        seen.append("gate")
        return real_shared()

    def pin(index):
        seen.append("pin")
        return real_pin(index)
    monkeypatch.setattr(idx.mutate_gate, "shared", shared)
    monkeypatch.setattr(port_snapshot, "pin_index", pin)
    port_e.execute("w", f"Set({int(cols[0])}, g=2) Count(Row(g=2))")
    port_e.execute("w", "Count(Row(g=2))")
    assert seen == ["gate", "pin"]


def test_interrupted_query_stops(tmp_path_factory):
    import threading

    from featurebase_tpu_torch.executor.qcontext import (QueryCanceled,
                                                         QueryContext)
    _, port_e, _, cols = build(tmp_path_factory)
    ev = threading.Event()
    ev.set()
    with QueryContext(cancel_ev=ev):
        with pytest.raises(QueryCanceled):
            port_e.execute("w", f"Set({int(cols[0])}, g=2)")
    assert port_e.execute("w", f"Set({int(cols[0])}, g=2)") in ([True],
                                                               [False])


def test_fragment_row_writes_follow_the_mirror():
    """merge_row_words, write_row_words and clear_row bump the generation
    (the plan executor's caches key on it) and mark their slot dirty (the
    device mirror uploads it on the next read)."""
    from featurebase_tpu_torch.model.fragment import Fragment
    frag = Fragment("i", "f", "standard", 0)
    frag.set_bit(3, 5)
    frag.device_tile("cpu")

    def words(w0):
        w = np.zeros(frag.host_row(3).size, dtype=np.uint32)
        w[0] = w0
        return w
    for row, op, want in (
            (3, lambda: frag.merge_row_words(3, words(0b1011)),
             0b101011),
            (3, lambda: frag.merge_row_words(3, words(0b11), clear=True),
             0b101000),
            (7, lambda: frag.write_row_words(7, words(0b110)), 0b110),
            (3, lambda: frag.clear_row(3), 0)):
        gen = frag.generation
        op()
        assert frag.generation == gen + 2
        tile = frag.device_tile("cpu")
        assert int(tile[frag.slot_rows().index(row), 0]) == want
    assert frag.has_row(3) and not frag.host_row(3).any()
    frag.merge_row_words(9, words(1), clear=True)   # an absent row: no-op
    assert not frag.has_row(9)
