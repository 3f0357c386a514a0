"""The per-shard bitmap interpreter against the JAX executor.

Calls the plan compiler refuses (Row(f=null), Rows as an operand, UnionRows
and Limit as operands) run shard by shard in both executors
(featurebase_tpu_torch/executor/executor.py ``_bitmap_call_shard``); so do
Count, TopN, Sum, Min and Max under such a filter.  A seeded three-shard
Holder is built with the JAX package, saved with its snapshot writer and
loaded into the port.  The BSI rows of the interpreter (ops/bsi.py
``range_*``, lowered onto kernel A at S = 1) are held at depths 1, 14, 31
and 32, through the executor and against the JAX package's static-predicate
comparators directly.  Answers must be equal: columns, counts, pairs in
order, (value, count)."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.ops import bsi as jbsi
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.ops import bsi as bsiops
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.storage import snapshot

N_SHARDS, N_RECORDS = 3, 1200
DEPTHS = {"w1": 1, "w14": 14, "w31": 31, "w32": 32}


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
    rng = np.random.default_rng(41)
    cols = np.sort(rng.choice(N_SHARDS * SW, size=N_RECORDS, replace=False))
    holder = JaxHolder()
    idx = holder.create_index("b")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("m", JaxFieldOptions(type="mutex"))
    idx.create_field("t", JaxFieldOptions(type="time", time_quantum="YMD"))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2))
    for name in DEPTHS:
        idx.create_field(name, JaxFieldOptions(type="int"))
    has_f = rng.random(N_RECORDS) < 0.8
    idx.field("f").import_bits(rng.integers(0, 5, int(has_f.sum())),
                               cols[has_f])
    has_g = rng.random(N_RECORDS) < 0.6
    idx.field("g").import_bits(rng.integers(0, 3, int(has_g.sum())),
                               cols[has_g])
    has_m = rng.random(N_RECORDS) < 0.7
    idx.field("m").import_bits(rng.choice([4, 8], int(has_m.sum())),
                               cols[has_m])
    for c in cols[rng.random(N_RECORDS) < 0.1]:
        day = int(rng.integers(1, 28))
        idx.field("t").set_bit(int(rng.integers(0, 3)), int(c),
                               timestamp=f"2003-03-{day:02d}T00:00")
    has_d = rng.random(N_RECORDS) < 0.6
    idx.field("d").import_values(
        cols[has_d], np.round(rng.uniform(-20, 30, int(has_d.sum())), 2))
    for name, depth in DEPTHS.items():
        top = (1 << depth) - 1
        has = rng.random(N_RECORDS) < 0.75
        vals = rng.integers(-top, top + 1, int(has.sum()))
        vals[rng.random(vals.size) < 0.05] = 0
        vals[:2] = (-top, top)
        idx.field(name).import_values(cols[has], vals)
        assert idx.field(name).bit_depth == depth
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("fb") / "holder")
    jax_snapshot.save(holder, path)
    return JaxExecutor(holder), Executor(snapshot.load(path), device="cpu")


def canon(r):
    if isinstance(r, (int, np.integer)):
        return ("value", int(r))
    if hasattr(r, "pairs"):
        return ("pairs", [(p.id, p.count) for p in r.pairs])
    if hasattr(r, "val"):
        return ("valcount", (r.val, r.count))
    return ("row", [int(c) for c in r.columns()])


def same(engines, pql):
    jax_e, port_e = engines
    want = canon(jax_e.execute("b", pql)[0])
    got = canon(port_e.execute("b", pql)[0])
    assert got == want, pql
    return got


BITMAPS = [
    "Row(f=null)", "Count(Row(g=null))", "Row(m=null)",
    "Not(Row(g=null))", "Count(Not(Row(f=null)))",
    "Shift(Row(f=null), n=5)", "Count(Shift(Row(g=null), n=70))",
    "Union(Row(f=null), ConstRow(columns=[0, 5, 1048580]))",
    "Intersect(Row(g=null), ConstRow(columns=[1, 2, 3, 2097152]))",
    "Xor(Row(f=null), Row(g=null))", "Difference(All(), Row(m=null))",
    "Intersect(Rows(f), Row(g=1))", "Count(Rows(m))",
    "Intersect(Rows(t), Not(Row(f=null)))",
    "Difference(Rows(g), Row(f=2))", "Count(Union(Rows(g), Row(f=null)))",
    "Count(Rows(t, from=2003-03-05T00:00, to=2003-03-20T00:00))",
    "Intersect(Rows(t, from=2003-03-10T00:00), Row(f=1))",
    "Count(Intersect(Rows(f), Not(Rows(g))))",
    "Intersect(Row(f=null), Row(t=1, from=2003-03-01T00:00, "
    "to=2003-03-15T00:00))",
    "Count(Union(Row(f=3), Row(g=null), Row(m=4)))",
    "Count(Intersect(UnionRows(Rows(g)), Row(f=1)))",
    "Intersect(UnionRows(Rows(m)), Row(f=2))",
    "Intersect(Limit(Row(f=1), limit=20), Row(g=2))",
    "Count(Union(Limit(All(), offset=1100), Row(g=null)))",
    "Count(Xor(Limit(Row(f=4), limit=30, offset=3), UnionRows(Rows(g))))",
    "All(limit=4, offset=3)", "Count(All(limit=10, offset=1195))",
    "Options(Count(Row(g=null)), shards=[0, 2])",
    "Options(Intersect(Rows(f), Row(m=null)), shards=[1])",
    "Count(Intersect(Row(d > 10.5), Row(g=null)))",
    "Intersect(Row(d == null), Row(f=0))",
    "Count(Union(Row(g=null), Row(d != null)))",
]


@pytest.mark.parametrize("pql", BITMAPS)
def test_interpreted_bitmaps_match_jax(engines, pql):
    same(engines, pql)


PREDICATES = ["> 0", ">= -1", "< 1", "<= -1", "== 1", "!= 0", "== 0",
              "== null", "!= null", "> {top}", "< -{top}", ">= {top}",
              "== -{top}", "!= {big}"]


@pytest.mark.parametrize("pred", PREDICATES)
@pytest.mark.parametrize("fld", list(DEPTHS))
def test_interpreted_bsi_rows_match_jax(engines, fld, pred):
    """Row(w op x) next to Row(g=null): the interpreter's BSI row at the
    field's depth, counted and as columns."""
    top = (1 << DEPTHS[fld]) - 1
    p = pred.format(top=top, big=4 * top + 3)
    same(engines, f"Count(Intersect(Row({fld} {p}), Not(Row(g=null))))")
    same(engines, f"Union(Row({fld} {p}), Row(f=null))")


@pytest.mark.parametrize("fld", list(DEPTHS))
def test_interpreted_between_matches_jax(engines, fld):
    top = (1 << DEPTHS[fld]) - 1
    for lo, hi in ((-1, 1), (0, top // 3), (-top, -top // 2), (1, 2 * top)):
        same(engines, f"Count(Union(Row({lo} <= {fld} <= {hi}), "
                      f"Row(f=null)))")
        same(engines, f"Intersect(Row({lo} < {fld} < {hi}), Rows(g))")


def group_of(rng, depth: int, W: int = 64):
    ex = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    sign = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    planes = rng.integers(0, 1 << 32, (depth, W), dtype=np.uint64) \
        .astype(np.uint32)
    return np.concatenate([ex[None], sign[None], planes])


@pytest.mark.parametrize("depth", [1, 14, 31, 32])
def test_range_comparators_match_jax(depth):
    """ops/bsi.py range_* against featurebase_tpu/ops/bsi.py range_*, on a
    shard's group of random words (all-ones filter, as the executor
    passes), predicates in range, out of range and negative."""
    rng = np.random.default_rng(depth)
    g = group_of(rng, depth)
    full = np.full(g.shape[1], 0xFFFFFFFF, np.uint32)
    args = (g[2:], g[0], g[1], full)
    tg = torch.from_numpy(g.view(np.int32))
    top = (1 << depth) - 1
    for pred in (0, 1, -1, top // 2, -(top // 3), top, -top, top + 1,
                 -(top + 5)):
        def cmp(got, want):
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want))
        cmp(bsiops.range_eq(tg, pred, depth),
            jbsi.range_eq(*args, pred, depth))
        cmp(bsiops.range_neq(tg, pred, depth),
            jbsi.range_neq(*args, pred, depth))
        for eq in (False, True):
            cmp(bsiops.range_lt(tg, pred, depth, eq),
                jbsi.range_lt(*args, pred, depth, eq))
            cmp(bsiops.range_gt(tg, pred, depth, eq),
                jbsi.range_gt(*args, pred, depth, eq))
        cmp(bsiops.range_between(tg, pred, pred + top // 4 + 1, depth),
            jbsi.range_between(*args, pred, pred + top // 4 + 1, depth))


AGGREGATES = [
    "TopN(f, Row(g=null), n=3)", "TopN(f, Union(Row(g=null), Row(w14 > 0)))",
    "TopK(f, k=2, filter=Row(m=null))", "TopN(g, Rows(m))",
    "TopN(f, Intersect(UnionRows(Rows(g)), Row(m=8)), n=4)",
    "Sum(Row(g=null), field=w14)", "Sum(Row(m=null), field=d)",
    "Sum(Intersect(Rows(f), Row(g=null)), field=w32)",
    "Min(Row(g=null), field=w31)", "Max(Row(g=null), field=w32)",
    "Min(Row(f=null), field=w1)", "Max(Rows(t), field=w14)",
    "Min(Intersect(Rows(g), Row(m=null)), field=d)",
    "Max(Limit(Row(f=2), limit=40), field=w31)",
    "Options(Sum(Row(g=null), field=w31), shards=[2])",
    "Count(Intersect(Row(g=null), Row(w31 < 0)))",
]


@pytest.mark.parametrize("pql", AGGREGATES)
def test_aggregates_under_unplannable_filters_match_jax(engines, pql):
    same(engines, pql)


@pytest.mark.parametrize("pql", ["TopN(f, Row(g=null), n=3)",
                                 "TopN(f, Rows(m))"])
def test_topn_per_shard_branch_with_interpreted_filter(engines, pql):
    jax_e, port_e = engines
    j = JaxExecutor(jax_e.holder)
    p = Executor(port_e.holder, device="cpu")
    j.ROWS_STACKED_MAX_BYTES = 0
    p.ROWS_STACKED_MAX_BYTES = 0
    assert canon(p.execute("b", pql)[0]) == canon(j.execute("b", pql)[0])


def test_null_row_by_hand(engines):
    """Row(g=null) is the existing columns with no bit in g."""
    _, port_e = engines
    idx = port_e.holder.index("b")
    nulls = set(int(c) for c in port_e.execute("b", "Row(g=null)")[0]
                .columns())
    assert nulls == set(int(c) for c in port_e.execute(
        "b", "Difference(All(), Union(Row(g=0), Row(g=1), Row(g=2)))")[0]
        .columns())
    assert nulls and idx.field("g") is not None


def test_distinct_as_an_operand(engines):
    """A Distinct operand (it raised before Distinct was ported) is a
    Precomputed row of its non-negative values, in the planner and in the
    interpreter (under Row(g=null))."""
    same(engines, "Count(Intersect(Distinct(field=w14), Row(f=1)))")
    same(engines, "Count(Union(Row(g=null), Distinct(field=w14)))")


def test_cpu_interpreter_launches_no_kernel(engines):
    _, port_e = engines
    ck.reset_launches()
    port_e.execute("b", "Count(Union(Row(f=1), Row(f=null))) "
                        "Sum(Row(g=null), field=w14) Row(w14 > 5)")
    assert all(v == 0 for v in ck.launches().values())
