"""GroupBy through both executors, on each of its three paths.

A seeded three-shard Holder is built with the JAX package, saved with its
snapshot writer and loaded into the port.  Each query runs on both
executors on each path, forced alike on both by the one-shot caps set on
the instances (GROUPBY_ONESHOT_MAX_COUNTS / _MASK_BYTES):
  - stacked: every shard in one launch (the default caps);
  - one_shot: every combination at once for each shard (the mask cap set
    to what one shard needs, below what the stacked path needs): in the
    JAX package a loop over the shards; in the port one launch over every
    shard's mirrors (_group_by_launch), or the level-wise loop where that
    declines (counts of one dimension);
  - level_wise: per shard, one dimension at a time with pruning (both caps
    0).
A query whose filter the plan compiler refuses goes per shard on every
path.  The port's path is checked too.  The cases: one to three
dimensions, plannable and unplannable filters, Sum on an int and a decimal
field, having on count and on sum (decimal included), limit, keyed
dimensions, in=, previous= and limit= on a dimension, Options(shards=).
Results must be equal, group order included."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.model.index import IndexOptions as JaxIndexOptions
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.core.consts import WORDS_PER_ROW
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.executor.results import GroupCount
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.pql.parser import parse
from featurebase_tpu_torch.storage import snapshot

N_SHARDS, N_RECORDS = 3, 1500
KEYS = ["apple", "banana", "cherry", "date"]


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
    rng = np.random.default_rng(31)
    cols = np.sort(rng.choice(N_SHARDS * SW, size=N_RECORDS, replace=False))
    holder = JaxHolder()
    idx = holder.create_index("g", JaxIndexOptions(keys=False))
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("m", JaxFieldOptions(type="mutex"))
    idx.create_field("kf", JaxFieldOptions(keys=True))
    idx.create_field("v", JaxFieldOptions(type="int", min=-300, max=900))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2))
    idx.field("f").import_bits(rng.integers(0, 6, N_RECORDS), cols)
    extra = rng.random(N_RECORDS) < 0.3   # a second row on some records
    idx.field("f").import_bits(rng.integers(0, 6, int(extra.sum())),
                               cols[extra])
    has_g = rng.random(N_RECORDS) < 0.85  # Row(g=null) is not empty
    idx.field("g").import_bits(rng.integers(0, 4, int(has_g.sum())),
                               cols[has_g])
    has_m = rng.random(N_RECORDS) < 0.9
    idx.field("m").import_bits(rng.choice([10, 20, 30], int(has_m.sum())),
                               cols[has_m])
    ids = idx.row_translation("kf").create_keys(KEYS)
    idx.field("kf").import_bits(
        np.array([ids[KEYS[i]] for i in rng.integers(0, 4, N_RECORDS)]),
        cols)
    has_v = rng.random(N_RECORDS) < 0.8
    idx.field("v").import_values(cols[has_v],
                                 rng.integers(-300, 900, int(has_v.sum())))
    has_d = rng.random(N_RECORDS) < 0.7
    idx.field("d").import_values(
        cols[has_d], np.round(rng.uniform(-50, 80, int(has_d.sum())), 2))
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("gb") / "holder")
    jax_snapshot.save(holder, path)
    return JaxExecutor(holder), Executor(snapshot.load(path), device="cpu")


QUERIES = [
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), Rows(m))",
    "GroupBy(Rows(f), filter=Row(g=1))",
    "GroupBy(Rows(f), Rows(m), filter=Row(v > 100))",
    "GroupBy(Rows(g), Rows(m), Rows(f), filter=Row(-50 < v < 400))",
    "GroupBy(Rows(f), filter=Row(g=null))",
    "GroupBy(Rows(f), Rows(g), filter=Union(Row(m=null), Row(v < 0)))",
    "GroupBy(Rows(f), aggregate=Sum(field=v))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "GroupBy(Rows(g), Rows(m), Rows(f, in=[1, 2]), aggregate=Sum(field=d))",
    "GroupBy(Rows(f), aggregate=Sum(field=d), filter=Row(g=null))",
    "GroupBy(Rows(m), Rows(g), aggregate=Sum(field=v), filter=Row(f=2))",
    "GroupBy(Rows(f), having=Condition(count > 150))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v), "
    "having=Condition(sum > 12000))",
    "GroupBy(Rows(f), aggregate=Sum(field=d), having=Condition(sum < 1500.5))",
    "GroupBy(Rows(g), Rows(m), aggregate=Sum(field=d), "
    "having=Condition(-100.25 <= sum <= 600.75))",
    "GroupBy(Rows(f), Rows(g), having=Condition(count == 24))",
    "GroupBy(Rows(f), limit=3)",
    "GroupBy(Rows(f), Rows(g), limit=7, aggregate=Sum(field=v))",
    "GroupBy(Rows(kf), Rows(g))",
    'GroupBy(Rows(kf, like="%an%"), Rows(m), aggregate=Sum(field=v))',
    "GroupBy(Rows(f, previous=1), Rows(g, in=[0, 3]))",
    "GroupBy(Rows(f, limit=2), Rows(m))",
    "GroupBy(Rows(f, in=[99]), Rows(g))",
    "Options(GroupBy(Rows(f), Rows(g)), shards=[0, 2])",
    "Options(GroupBy(Rows(f), aggregate=Sum(field=v)), shards=[1, 2])",
    "GroupBy(Rows(f), Rows(g), aggregate=Count())",
]
PATHS = ["stacked", "one_shot", "level_wise"]


def norm(result):
    assert isinstance(result, list)
    return [(tuple(fr.row_key if fr.row_key is not None else fr.row_id
                   for fr in gc.group), gc.count, gc.agg, gc.decimal_agg)
            for gc in result]


def mask_bytes_one_shot(port_e, pql: str) -> int:
    """A mask cap the per-shard one-shot meets and the stacked path (every
    shard's bytes at once) does not: what the global dimensions need of one
    shard."""
    call = parse(pql).calls[0]
    while call.name == "Options":
        call = call.children[0]
    idx = port_e.holder.index("g")
    call = port_e._pre_translate(idx, call)
    rows = [len(port_e._execute_rows(idx, rc, None, verify_nonempty=False))
            for rc in call.children if rc.name == "Rows"]
    agg = call.args.get("aggregate")
    need = int(np.prod(rows if getattr(agg, "name", None) == "Sum"
                       else rows[:-1]))
    return max(need, 1) * WORDS_PER_ROW * 4


def force(executor, path: str, one_shot_bytes: int) -> None:
    if path == "one_shot":
        executor.GROUPBY_ONESHOT_MAX_MASK_BYTES = one_shot_bytes
    elif path == "level_wise":
        executor.GROUPBY_ONESHOT_MAX_COUNTS = 0
        executor.GROUPBY_ONESHOT_MAX_MASK_BYTES = 0


def watch(port_e) -> dict:
    """Record the port's path: what _group_by_stacked and _group_by_launch
    returned, and the shards the level-wise loop ran."""
    seen = {"stacked": [], "launch": [], "shard_device": []}
    for name in seen:
        real = getattr(port_e, f"_group_by_{name}")

        def spy(*a, real=real, name=name):
            r = real(*a)
            seen[name].append(r)
            return r
        setattr(port_e, f"_group_by_{name}", spy)
    return seen


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("pql", QUERIES)
def test_group_by_matches_jax(engines, pql, path):
    jax_h, port_h = engines[0].holder, engines[1].holder
    jax_e, port_e = JaxExecutor(jax_h), Executor(port_h, device="cpu")
    cap = mask_bytes_one_shot(port_e, pql)
    force(jax_e, path, cap)
    force(port_e, path, cap)
    seen = watch(port_e)
    got, want = port_e.execute("g", pql)[0], jax_e.execute("g", pql)[0]
    assert norm(got) == norm(want)
    if "null" in pql or "in=[99]" in pql:
        return   # per shard on every path, or no groups at all
    if path == "stacked":
        assert seen["stacked"] == [True]
        return
    assert seen["stacked"] == [False]
    launched = seen["launch"] == [True]
    assert launched != bool(seen["shard_device"])
    if path == "one_shot":
        call = parse(pql).calls[0]
        while call.name == "Options":
            call = call.children[0]
        one_level_count = len(call.children) == 1 and "Sum" not in pql
        assert launched != one_level_count
    else:
        assert not launched


def test_group_by_answers_are_sorted_groups(engines):
    _, port_e = engines
    res = port_e.execute("g", "GroupBy(Rows(f), Rows(g), Rows(m))")[0]
    assert res and all(isinstance(gc, GroupCount) for gc in res)
    keys = [tuple(fr.row_id for fr in gc.group) for gc in res]
    assert keys == sorted(keys) and all(gc.count > 0 for gc in res)
    assert [fr.field for fr in res[0].group] == ["f", "g", "m"]


def test_group_by_counts_match_the_records(engines):
    """One dimension's counts are the rows' bit counts, by hand."""
    _, port_e = engines
    res = port_e.execute("g", "GroupBy(Rows(g))")[0]
    for gc in res:
        r = gc.group[0].row_id
        assert gc.count == port_e.execute("g", f"Count(Row(g={r}))")[0]


def test_group_by_decimal_sum_and_keys(engines):
    jax_e, port_e = engines
    q = 'GroupBy(Rows(kf), aggregate=Sum(field=d))'
    got, want = port_e.execute("g", q)[0], jax_e.execute("g", q)[0]
    assert [fr.row_key for gc in got for fr in gc.group] == sorted(KEYS)
    assert norm(got) == norm(want)
    assert all(gc.decimal_agg == gc.agg / 100 for gc in got)


def test_group_by_count_distinct_aggregate(engines):
    """aggregate=Count(Distinct(...)) (it raised before Distinct was
    ported): each group's agg is the count of the distinct values under the
    group's rows and the filter."""
    jax_e, port_e = engines
    for q in ("GroupBy(Rows(f), aggregate=Count(Distinct(field=v)))",
              "GroupBy(Rows(f), Rows(kf), filter=Row(g=1), "
              "aggregate=Count(Distinct(field=d)))"):
        assert norm(port_e.execute("g", q)[0]) == \
            norm(jax_e.execute("g", q)[0])


def test_group_by_needs_a_rows_child(engines):
    from featurebase_tpu_torch.executor.executor import ExecError
    _, port_e = engines
    with pytest.raises(ExecError, match="Rows"):
        port_e.execute("g", "GroupBy(Row(f=1))")


def test_cpu_group_by_launches_no_kernel(engines):
    _, port_e = engines
    ck.reset_launches()
    port_e.execute("g", "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))")
    assert all(v == 0 for v in ck.launches().values())
