"""Distinct through both executors, at all four of its sites.

A seeded Holder is built with the JAX package, saved, and loaded into the
port.  Distinct as a call (set fields: kernel B over stacked rows or a
launch a shard; BSI fields: torch.unique over the stacked decode of kernel
G, a shard's decode under a filter the plan compiler refuses, or the host
decode past depth 31), under Count, as a bitmap operand (taken as a
Precomputed row by the port's planner, and by the per-shard interpreter
under an unplannable parent), and as GroupBy's aggregate=Count(Distinct).
Keyed set fields translate to row keys; an unkeyed field stays numeric on
a keyed index.  The decode switches to the host at depth 32 in both
packages: fields of depth 31 and 32 are both cases."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.model.index import IndexOptions as JaxIndexOptions
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.model.row import Row, SignedRow
from featurebase_tpu_torch.storage import snapshot

KEYS = ["north", "south", "east", "west", "up"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(47)
    n = 2000
    cols = np.sort(rng.choice(3 * SW, n, replace=False))
    holder = JaxHolder()
    idx = holder.create_index("d")
    idx.create_field("f")
    idx.field("f").import_bits(rng.integers(0, 5, n), cols)
    idx.create_field("g")
    has_g = rng.random(n) < 0.7
    idx.field("g").import_bits(rng.integers(0, 4, int(has_g.sum())),
                               cols[has_g])
    idx.create_field("v", JaxFieldOptions(type="int", min=-60, max=300))
    has_v = rng.random(n) < 0.9
    idx.field("v").import_values(cols[has_v],
                                 rng.integers(-60, 300, int(has_v.sum())))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=1,
                                          min=-20, max=20))
    idx.field("d").import_values(cols, np.round(rng.uniform(-20, 20, n), 1))
    for name, bits in (("w31", 31), ("w32", 32), ("w43", 43)):
        top = (1 << bits) - 1
        idx.create_field(name, JaxFieldOptions(type="int", min=-top,
                                               max=top))
        vals = rng.integers(-30, 30, n) * (1 << (bits - 6))
        vals[:2] = [top, -top]
        idx.field(name).import_values(cols, vals)
    idx.create_field("kf", JaxFieldOptions(keys=True))
    ids = idx.row_translation("kf").create_keys(KEYS)
    idx.field("kf").import_bits(
        np.array([ids[KEYS[i]] for i in rng.integers(0, 4, n)]), cols)
    idx.mark_exists(cols)
    kidx = holder.create_index("k", JaxIndexOptions(keys=True))
    kidx.create_field("n", JaxFieldOptions(type="int", min=0, max=50))
    kidx.create_field("s")
    recs = [f"r{i}" for i in range(30)]
    rids = kidx.translate_store.create_keys(recs)
    kcols = np.array([rids[r] for r in recs], dtype=np.int64)
    kidx.field("n").import_values(kcols, rng.integers(0, 50, 30))
    kidx.field("s").import_bits(rng.integers(0, 6, 30), kcols)
    kidx.mark_exists(kcols)
    path = str(tmp_path_factory.mktemp("distinct") / "holder")
    jax_snapshot.save(holder, path)
    return JaxExecutor(holder), Executor(snapshot.load(path), device="cpu")


def canon(r):
    if isinstance(r, SignedRow) or type(r).__name__ == "SignedRow":
        return ("signed", r.values().tolist())
    if hasattr(r, "segments"):
        return ("row", r.columns().tolist(), r.keys)
    if hasattr(r, "val"):
        return ("valcount", r.val, r.count)
    if isinstance(r, list):
        return [(tuple(fr.row_id for fr in gc.group), gc.count, gc.agg)
                for gc in r]
    return r


QUERIES = [
    "Distinct(field=f)",
    "Distinct(Row(g=1), field=f)",
    "Distinct(Row(v > 100), field=g)",
    "Distinct(Union(Row(g=null), Row(f=4)), field=g)",
    "Distinct(Row(f=99), field=g)",
    "Distinct(field=v)",
    "Distinct(Row(f=2), field=v)",
    "Distinct(Row(v < 0), field=v)",
    "Distinct(Union(Row(g=null), Row(f=1)), field=v)",
    "Distinct(Row(f=99), field=v)",
    "Distinct(field=d)",
    "Distinct(Row(g=2), field=d)",
    "Distinct(field=w31)", "Distinct(field=w32)", "Distinct(field=w43)",
    "Distinct(Row(f=3), field=w31)", "Distinct(Row(f=3), field=w32)",
    "Distinct(Union(Row(g=null), Row(f=0)), field=w43)",
    "Count(Distinct(field=f))", "Count(Distinct(field=v))",
    "Count(Distinct(Row(g=3), field=v))", "Count(Distinct(field=w43))",
    "Count(Distinct(Row(f=99), field=v))",
    # Distinct as an operand: the planner's Precomputed leaf ...
    "Count(Intersect(Row(f=1), Distinct(Row(g=2), field=f)))",
    "Intersect(Row(g=1), Distinct(field=v))",
    "Count(Difference(All(), Distinct(Row(f=0), field=v)))",
    "Sum(Distinct(Row(f=0), field=v), field=v)",
    # ... and the interpreter's, under an operand the planner refuses
    "Count(Union(Row(g=null), Distinct(Row(g=0), field=f)))",
    "Count(Intersect(Row(f=null), Distinct(field=g)))",
    "GroupBy(Rows(g), aggregate=Count(Distinct(field=v)))",
    "GroupBy(Rows(f), Rows(g), aggregate=Count(Distinct(field=d)))",
    "GroupBy(Rows(f), aggregate=Count(Distinct(Row(v > 50), field=v)), "
    "filter=Row(g=1))",
    "GroupBy(Rows(g), aggregate=Count(Distinct(field=f)), "
    "having=Condition(count > 150))",
    "Options(Distinct(field=v), shards=[1])",
    "Distinct(field=kf)",
    "Distinct(Row(f=1), field=kf)",
    "Distinct(Row(f=1), field=g)",   # chip_smoke.py's
]


@pytest.mark.parametrize("query", QUERIES)
def test_distinct_matches_jax(engines, query):
    jax_e, port_e = engines
    assert canon(port_e.execute("d", query)[0]) == \
        canon(jax_e.execute("d", query)[0])


@pytest.mark.parametrize("query", [
    "Distinct(field=n)", "Distinct(field=s)", "Count(Distinct(field=n))",
    "Count(Intersect(All(), Distinct(field=s)))"])
def test_keyed_index_keeps_distinct_values_numeric(engines, query):
    jax_e, port_e = engines
    got = port_e.execute("k", query)[0]
    assert canon(got) == canon(jax_e.execute("k", query)[0])
    if isinstance(got, Row):
        assert got.keys is None


def test_keyed_field_translates_to_row_keys(engines):
    _, port_e = engines
    got = port_e.execute("d", "Distinct(field=kf)")[0]
    assert sorted(got.keys) == sorted(KEYS[:4])


def test_set_field_per_shard_loop(engines):
    """Above ROWS_STACKED_MAX_BYTES the rows are counted a shard at a
    time; the answers stay."""
    jax_e, port_e = engines
    p = Executor(port_e.holder, device="cpu")
    p.ROWS_STACKED_MAX_BYTES = 0
    for q in ("Distinct(field=f)", "Distinct(Row(v > 100), field=g)",
              "Count(Distinct(Row(f=1), field=g))"):
        assert canon(p.execute("d", q)[0]) == canon(jax_e.execute("d", q)[0])


@pytest.mark.parametrize("field,host", [("w31", False), ("w32", True),
                                        ("w43", True)])
def test_decode_switches_to_the_host_at_32(engines, monkeypatch, field,
                                           host):
    from featurebase_tpu_torch.model.field import Field
    _, port_e = engines
    calls = []
    real = Field.values_dense_host
    monkeypatch.setattr(Field, "values_dense_host",
                        lambda self, s: calls.append(s) or real(self, s))
    port_e.execute("d", f"Distinct(Union(Row(g=null), Row(f=1)), "
                        f"field={field})")
    assert bool(calls) == host


def test_results_are_port_types(engines):
    _, port_e = engines
    signed, row = port_e.execute("d", "Distinct(field=v) Distinct(field=f)")
    assert isinstance(signed, SignedRow) and isinstance(row, Row)
    assert signed.to_json()["values"] == signed.values().tolist()
