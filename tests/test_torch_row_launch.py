"""Kernel B' over every shard's mirrors in one launch, through the executor.

The per-shard loops that launched kernel B once a shard now make one
row_counts_sharded launch per residency batch: MinRow/MaxRow, level 0 of
the per-shard level-wise GroupBy, and the per-shard fallbacks of TopN and of
set-field Distinct.  Each is held against the JAX executor over the same
Holder, exactly, on the paths that reach them: GroupBy with both one-shot
caps at 0 (under no filter, a plannable one and one the plan compiler
refuses), TopN and Distinct with ROWS_STACKED_MAX_BYTES at 0.  The Holder
has ties of MinRow/MaxRow across shards, a shard without the fragment and a
time field read over several views.  Then the launches: MinRow takes one
row_counts launch per residency batch (a fake wrapper that counts on the
CPU), and the per-shard GroupBy one for its level 0."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.core.consts import WORDS_PER_ROW as W
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.storage import residency, snapshot

N_SHARDS, N_RECORDS = 5, 2500


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """f: rows 0-6, none in shard 3; rows 0 and 6 in shards 0, 2 and 4 (the
    MinRow and MaxRow ties); g: rows 0-3 on 80% of the records; h: rows 0-2;
    v: int in [-500, 9000]; t: a time field over several days."""
    rng = np.random.default_rng(43)
    cols = np.sort(rng.choice(N_SHARDS * SW, size=N_RECORDS, replace=False))
    shard = cols // SW
    holder = JaxHolder()
    idx = holder.create_index("r")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("h")
    idx.create_field("t", JaxFieldOptions(type="time", time_quantum="YMD"))
    idx.create_field("v", JaxFieldOptions(type="int", min=-500, max=9000))
    in_f = shard != 3
    f_rows = rng.integers(1, 6, int(in_f.sum()))
    idx.field("f").import_bits(f_rows, cols[in_f])
    for s in (0, 2, 4):
        at = cols[shard == s]
        idx.field("f").import_bits(np.array([0, 0, 6]), at[:3])
    has_g = rng.random(N_RECORDS) < 0.8
    idx.field("g").import_bits(rng.integers(0, 4, int(has_g.sum())),
                               cols[has_g])
    idx.field("h").import_bits(rng.integers(0, 3, N_RECORDS), cols)
    for c in cols[rng.random(N_RECORDS) < 0.2]:
        day = int(rng.integers(1, 20))
        idx.field("t").set_bit(int(rng.integers(0, 4)), int(c),
                               timestamp=f"2004-05-{day:02d}T00:00")
    has_v = rng.random(N_RECORDS) < 0.85
    idx.field("v").import_values(cols[has_v],
                                 rng.integers(-500, 9000, int(has_v.sum())))
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("rows") / "holder")
    jax_snapshot.save(holder, path)
    return holder, snapshot.load(path)


def canon(r):
    if hasattr(r, "pair"):
        return ("pair", (r.pair.id, r.pair.count))
    if hasattr(r, "pairs"):
        return ("pairs", [(p.id, p.count) for p in r.pairs])
    if isinstance(r, list):
        return ("groups", [(tuple(fr.row_id for fr in gc.group), gc.count,
                            gc.agg) for gc in r])
    return ("row", [int(c) for c in r.columns()])


def both(engines, q: str, **caps):
    """Both executors' answers to q, with `caps` set on each; the port's
    rank cache cleared first, so TopN counts on the kernel path."""
    jax_e, port_e = JaxExecutor(engines[0]), Executor(engines[1],
                                                      device="cpu")
    for e in (jax_e, port_e):
        for k, v in caps.items():
            setattr(e, k, v)
    for fld in engines[1].index("r").fields.values():
        fld._topn_cache.clear()
    want = canon(jax_e.execute("r", q)[0])
    got = canon(port_e.execute("r", q)[0])
    assert got == want, q
    return got


MIN_MAX = [
    "MinRow(field=f)", "MaxRow(field=f)", "MinRow(field=g)",
    "MaxRow(field=h)", "Options(MinRow(field=f), shards=[1, 3])",
    "Options(MaxRow(field=f), shards=[3])",
]


@pytest.mark.parametrize("q", MIN_MAX)
def test_min_max_row_matches_jax(engines, q):
    both(engines, q)


def test_min_max_row_ties_add_counts(engines):
    assert both(engines, "MinRow(field=f)") == ("pair", (0, 6))
    assert both(engines, "MaxRow(field=f)") == ("pair", (6, 3))


GROUP_BYS = [
    "GroupBy(Rows(f))",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
    "GroupBy(Rows(f), Rows(g), filter=Row(v > 3000))",
    "GroupBy(Rows(g), filter=Row(v > 3000))",
    "GroupBy(Rows(f), filter=Union(Row(g=1), Row(f=null)))",
    "GroupBy(Rows(f), Rows(h), filter=Union(Row(g=1), Row(f=null)))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "GroupBy(Rows(g), Rows(f), aggregate=Sum(field=v), "
    "filter=Row(v > 3000))",
    "GroupBy(Rows(f, in=[0, 6]), Rows(h))",
    "Options(GroupBy(Rows(f), Rows(h)), shards=[3, 4])",
]
PER_SHARD = dict(GROUPBY_ONESHOT_MAX_COUNTS=0,
                 GROUPBY_ONESHOT_MAX_MASK_BYTES=0)


@pytest.mark.parametrize("q", GROUP_BYS)
def test_per_shard_group_by_matches_jax(engines, q):
    both(engines, q, **PER_SHARD)


FALLBACKS = [
    "TopN(f, n=3)",
    "TopN(f)",
    "TopN(g, Row(v > 3000), n=2)",
    "TopN(h, Union(Row(g=1), Row(f=null)))",
    "TopN(t, from=2004-05-03T00:00, to=2004-05-12T00:00)",
    "Options(TopN(f, n=2), shards=[2, 3])",
    "Distinct(field=f)",
    "Distinct(Row(v > 3000), field=g)",
    "Distinct(Union(Row(g=1), Row(f=null)), field=f)",
    "Options(Distinct(field=f), shards=[3])",
]


@pytest.mark.parametrize("q", FALLBACKS)
def test_per_shard_fallbacks_match_jax(engines, q):
    both(engines, q, ROWS_STACKED_MAX_BYTES=0)


def counting(monkeypatch):
    """A fake row_counts_sharded that records each launch's shard count
    and runs the plain version."""
    calls = []
    real = ck.row_counts_sharded

    def fake(tiles, slots, filt=None):
        calls.append(len(tiles))
        return real(tiles, slots, filt)
    monkeypatch.setattr(ck, "row_counts_sharded", fake)
    return calls


@pytest.mark.parametrize("budget_rows", [None, 8])
def test_min_row_launches_once_a_residency_batch(engines, monkeypatch,
                                                 budget_rows):
    """One launch over every shard, or one a batch when the residency
    budget (in rows of W words) cuts the shards."""
    port_e = Executor(engines[1], device="cpu")
    idx = engines[1].index("r")
    v = idx.field("f").view("standard")
    shards = port_e._shards(idx, None)
    old = residency.residency()
    try:
        if budget_rows is not None:
            residency.reset(budget_rows * W * 4)
        batches = port_e._residency_batches(shards, [v])
        calls = counting(monkeypatch)
        got = canon(port_e.execute("r", "MinRow(field=f)")[0])
    finally:
        residency._global = old
    assert got == ("pair", (0, 6))
    # shards without the fragment are left out of their batch's launch
    want = [sum(1 for s in b if v.fragment(s) is not None) for b in batches]
    assert calls == [n for n in want if n]
    if budget_rows is None:
        assert calls == [N_SHARDS - 1]
    else:
        assert len(calls) >= 2


@pytest.mark.parametrize("q", GROUP_BYS[:6])
def test_per_shard_group_by_counts_level0_in_one_launch(engines, monkeypatch,
                                                        q):
    port_e = Executor(engines[1], device="cpu")
    for k, val in PER_SHARD.items():
        setattr(port_e, k, val)
    calls = counting(monkeypatch)
    port_e.execute("r", q)
    assert len(calls) == 1, calls
