"""Kernels G'' and G''' over every shard's BSI mirrors in one launch.

First the plain versions of the sharded forms (bsi_decode_sharded and
bsi_decode_gather_sharded; the wrappers take them on CPU tensors) against
the JAX package's decode_values and decode_gather, shard by shard, over the
same numpy groups (made from a seed): per-shard groups given as a
fragment-like tile with a slot for each plane (rows out of order, spare
rows, absent planes at -1) or as a (D + 2, W) view, a shard without data,
empty column lists, depths 1, 14 and 31 and an odd W.  The reference sees
the same bits with every absent plane and shard as zeros.  Then the
wrappers' checks: depth 32 raises in both packages, and columns out of
range or on a device raise on the host.  Then Extract, and Distinct and
Sort under Union(Row(g=1), Row(f=null)) (a filter the plan compiler
refuses), through both executors, on an index where two shards lack the
BSI field v and a second field is 43 planes deep (the host decode); and the
launches: one sharded launch per residency batch, at the default budget
and at a small one.  Answers are integers: the tolerance is zero.  The CUDA
kernels are held against these plain versions on the card by
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.ops import bsi as jbsi
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.core.consts import WORDS_PER_ROW
from featurebase_tpu_torch.executor.executor import (DECODE_ROWS, SORT_ROWS,
                                                     Executor)
from featurebase_tpu_torch.model.view import view_bsi_group
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import decode
from featurebase_tpu_torch.storage import residency, snapshot

S = 5
ABSENT_SHARD, NO_SIGN, VIEWED, NO_COLUMNS = 1, 2, 4, 3
DEPTHS = (1, 14, 31)
WIDTHS = (64, 1001)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def make_shards(depth: int, W: int):
    """The port's per-shard groups and the reference's stacked group of the
    same bits, (S, D + 2, W) uint32: random words, a fifth of the planes
    absent (zeros in the reference), shard NO_SIGN without its sign plane,
    shard ABSENT_SHARD without data (None); shard VIEWED is a (D + 2, W)
    view, the others a tile of their present planes in random order with
    two spare rows and a slot a plane."""
    rng = np.random.default_rng([depth, W])
    ref = rng.integers(0, 1 << 32, size=(S, depth + 2, W),
                       dtype=np.uint64).astype(np.uint32)
    absent = rng.random((S, depth + 2)) < 0.2
    absent[NO_SIGN, 1] = True
    absent[ABSENT_SHARD] = True
    ref[absent] = 0
    groups = []
    for s in range(S):
        if s == ABSENT_SHARD:
            groups.append(None)
        elif s == VIEWED:
            wide = np.zeros((depth + 4, W + 3), dtype=np.uint32)
            wide[1:depth + 3, 2:W + 2] = ref[s]
            groups.append(t(wide)[1:depth + 3, 2:W + 2])
        else:
            present = np.flatnonzero(~absent[s])
            order = rng.permutation(present.size + 2)
            tile = rng.integers(0, 1 << 32, size=(present.size + 2, W),
                                dtype=np.uint64).astype(np.uint32)
            slots = np.full(depth + 2, -1, dtype=np.int64)
            for p, row in zip(present, order):
                tile[row] = ref[s, p]
                slots[p] = row
            groups.append((t(tile), slots))
    return groups, ref


def shard_columns(W: int, n: int, seed: int):
    """In-shard column ids a shard (n of them, unsorted, the last column
    of the shard among them), none for shard NO_COLUMNS."""
    rng = np.random.default_rng(seed)
    cols = []
    for s in range(S):
        if s == NO_COLUMNS:
            cols.append(np.zeros(0, dtype=np.int64))
            continue
        c = rng.choice(32 * W, min(n, 32 * W), replace=False)
        c[0] = 32 * W - 1
        cols.append(c)
    return cols


CASES = [(d, w) for d in DEPTHS for w in WIDTHS]


@pytest.mark.parametrize("depth, W", CASES)
def test_sharded_decode_matches_jax(depth, W):
    groups, ref = make_shards(depth, W)
    got = ck.bsi_decode_sharded(groups)
    assert got.dtype == torch.int32 and tuple(got.shape) == (S, 32 * W)
    want = np.asarray(jbsi.decode_values(jnp.asarray(ref[:, 2:]),
                                         jnp.asarray(ref[:, 1]), depth))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[ABSENT_SHARD].any()
    # the stacked form over the reference's bits
    assert torch.equal(ck.bsi_decode(t(ref)), got)


@pytest.mark.parametrize("depth, W", CASES)
@pytest.mark.parametrize("n", (1, 37, 600))
def test_sharded_gather_matches_jax(depth, W, n):
    groups, ref = make_shards(depth, W)
    cols = shard_columns(W, n, depth * 1000 + n)
    vals, ok = ck.bsi_decode_gather_sharded(groups, cols)
    assert vals.dtype == ok.dtype == torch.int32
    at = 0
    for s in range(S):
        c = cols[s]
        want_v, want_ok = (np.asarray(x) for x in jbsi.decode_gather(
            jnp.asarray(ref[s, 2:]), jnp.asarray(ref[s, 0]),
            jnp.asarray(ref[s, 1]), jnp.asarray(c.astype(np.int32)), depth))
        np.testing.assert_array_equal(vals[at:at + c.size].numpy(), want_v)
        np.testing.assert_array_equal(ok[at:at + c.size].numpy(), want_ok)
        at += c.size
    assert at == vals.numel() == ok.numel()
    start = sum(c.size for c in cols[:ABSENT_SHARD])
    assert not ok[start:start + cols[ABSENT_SHARD].size].any()


def test_one_shard_gather_is_the_sharded_one():
    groups, ref = make_shards(14, 64)
    cols = shard_columns(64, 37, 5)
    for s in (0, VIEWED):
        single = ck.bsi_decode_gather(t(ref[s]), cols[s])
        sharded = ck.bsi_decode_gather_sharded([groups[s]], [cols[s]])
        for a, b in zip(single, sharded):
            assert torch.equal(a, b)
        assert torch.equal(
            single[0], ck.bsi_decode_gather(t(ref[s]),
                                            torch.from_numpy(cols[s]))[0])


def test_empty_column_lists():
    groups, _ = make_shards(14, 64)
    vals, ok = ck.bsi_decode_gather_sharded(
        groups, [np.zeros(0, dtype=np.int64)] * S)
    assert vals.numel() == ok.numel() == 0
    vals, ok = ck.bsi_decode_gather_sharded(groups, [[]] * S)
    assert vals.numel() == ok.numel() == 0


@pytest.mark.parametrize("depth", (32, 43))
def test_depth_32_raises_in_both_packages(depth):
    rng = np.random.default_rng(depth)
    ref = rng.integers(0, 1 << 32, size=(2, depth + 2, 64),
                       dtype=np.uint64).astype(np.uint32)
    with pytest.raises(ValueError):
        jbsi.decode_values(jnp.asarray(ref[:, 2:]), jnp.asarray(ref[:, 1]),
                           depth)
    groups = [t(ref[0]), (t(ref[1]), np.arange(depth + 2))]
    with pytest.raises(ValueError):
        ck.bsi_decode_sharded(groups)
    with pytest.raises(ValueError):
        ck.bsi_decode_gather_sharded(groups, [[0], [1]])


def test_columns_are_checked_on_the_host():
    groups, _ = make_shards(14, 64)
    cols = shard_columns(64, 5, 1)
    for bad in (32 * 64, -1):
        wrong = list(cols)
        wrong[2] = np.array([3, bad])
        with pytest.raises(ValueError, match="columns"):
            ck.bsi_decode_gather_sharded(groups, wrong)
    with pytest.raises(ValueError, match="host"):
        ck.bsi_decode_gather_sharded(
            groups, cols[:4] + [torch.zeros(3, dtype=torch.int64,
                                            device="meta")])
    with pytest.raises(ValueError):
        ck.bsi_decode_gather_sharded(groups, cols[:4])      # a list short
    with pytest.raises(ValueError):
        ck.bsi_decode_gather_sharded(groups, cols[:4] + [np.array([0.5])])


def test_group_checks():
    groups, _ = make_shards(14, 64)
    mixed = list(groups)
    mixed[0] = (groups[0][0], groups[0][1][:-1])      # one plane short
    with pytest.raises(ValueError):
        ck.bsi_decode_sharded(mixed)
    with pytest.raises(ValueError):
        ck.bsi_decode_sharded([None, None])          # no shard with data
    bad = list(groups)
    bad[0] = (groups[0][0], np.where(groups[0][1] >= 0, 99, -1))
    with pytest.raises(ValueError):
        ck.bsi_decode_sharded(bad)                   # a slot past its tile


# -- through the executors ----------------------------------------------------

N_SHARDS, N_RECORDS = 6, 3000
NO_V = (2, 4)          # shards without field v


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """f, g: set fields (f on 70% of the records, g rows 0-3 on 80%); v: int
    in [-500, 9000], none in shards 2 and 4; d: decimal (scale 2); w: int
    at depth 43, half negative."""
    rng = np.random.default_rng(53)
    cols = np.sort(rng.choice(N_SHARDS * SW, size=N_RECORDS, replace=False))
    shard = cols // SW
    holder = JaxHolder()
    idx = holder.create_index("b")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", JaxFieldOptions(type="int", min=-500, max=9000))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2,
                                          min=-100, max=100))
    idx.create_field("w", JaxFieldOptions(type="int", min=-(1 << 42),
                                          max=(1 << 42)))
    has_f = rng.random(N_RECORDS) < 0.7
    idx.field("f").import_bits(rng.integers(0, 5, int(has_f.sum())),
                               cols[has_f])
    has_g = rng.random(N_RECORDS) < 0.8
    idx.field("g").import_bits(rng.integers(0, 4, int(has_g.sum())),
                               cols[has_g])
    has_v = (rng.random(N_RECORDS) < 0.85) & ~np.isin(shard, NO_V)
    idx.field("v").import_values(cols[has_v],
                                 rng.integers(-500, 9000, int(has_v.sum())))
    has_d = rng.random(N_RECORDS) < 0.5
    idx.field("d").import_values(
        cols[has_d], rng.integers(-9999, 9999, int(has_d.sum())) / 100)
    has_w = rng.random(N_RECORDS) < 0.6
    idx.field("w").import_values(
        cols[has_w], rng.integers(-(1 << 42), 1 << 42, int(has_w.sum())))
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("decode") / "holder")
    jax_snapshot.save(holder, path)
    return holder, snapshot.load(path)


UNPLANNABLE = "Union(Row(g=1), Row(f=null))"
QUERIES = [
    f"Distinct({UNPLANNABLE}, field=v)",
    f"Distinct({UNPLANNABLE}, field=d)",
    f"Distinct({UNPLANNABLE}, field=w)",
    f"Count(Distinct({UNPLANNABLE}, field=v))",
    f"Options(Distinct({UNPLANNABLE}, field=v), shards=[2, 4])",
    f"Sort({UNPLANNABLE}, field=v, limit=10)",
    f"Sort({UNPLANNABLE}, field=v, sort-desc=true, limit=7, offset=2)",
    f"Sort({UNPLANNABLE}, field=v)",
    f"Sort({UNPLANNABLE}, field=w, limit=5)",
    f"Sort({UNPLANNABLE}, field=v, limit=5, after=[100, 0])",
    f"Sort({UNPLANNABLE}, field=v, sort-desc=true, limit=4, "
    f"after=[8000, {3 * SW}])",
    f"Sort({UNPLANNABLE}, field=d, limit=6, offset=1)",
    f"Options(Sort({UNPLANNABLE}, field=v, limit=3), shards=[2, 4])",
    "Sort(Row(g=2), field=v)",
    f"Extract({UNPLANNABLE}, Rows(v), Rows(g), Rows(d), Rows(w))",
    "Extract(Row(g=2), Rows(v), Rows(f))",
    "Extract(Limit(Row(f=1), limit=50), Rows(v), Rows(w))",
    "Options(Extract(Row(g=1), Rows(v), Rows(d)), shards=[1, 2])",
    "Options(Extract(Row(g=1), Rows(v)), shards=[2, 4])",
]


def canon(r):
    """Comparable form of a Distinct, Sort or Extract result."""
    if type(r).__name__ == "SignedRow":
        return ("signed", r.values().tolist())
    if hasattr(r, "col_ids"):
        return ([(f.name, f.type) for f in r.fields], list(r.col_ids),
                [list(v) for v in r.field_values])
    return r


@pytest.mark.parametrize("q", QUERIES)
def test_queries_match_jax(engines, q):
    jax_e, port_e = JaxExecutor(engines[0]), Executor(engines[1],
                                                      device="cpu")
    assert canon(port_e.execute("b", q)[0]) == \
        canon(jax_e.execute("b", q)[0])


def counting(monkeypatch):
    """Fake sharded wrappers that record each launch's shard count (and,
    for the gather, its columns) and run the plain versions."""
    calls = []
    real_dec = ck.bsi_decode_sharded
    real_gat = ck.bsi_decode_gather_sharded

    def fake_dec(groups):
        calls.append(("decode", len(groups)))
        return real_dec(groups)

    def fake_gat(groups, cols):
        calls.append(("gather", len(groups)))
        return real_gat(groups, cols)
    monkeypatch.setattr(ck, "bsi_decode_sharded", fake_dec)
    monkeypatch.setattr(ck, "bsi_decode_gather_sharded", fake_gat)
    return calls


LAUNCH_QUERIES = {
    "decode": [f"Distinct({UNPLANNABLE}, field=v)",
               f"Sort({UNPLANNABLE}, field=v, limit=10)",
               "Sort(Row(g=2), field=v)"],
    "gather": [f"Extract({UNPLANNABLE}, Rows(v), Rows(g))",
               "Extract(Row(g=2), Rows(v), Rows(f))"],
}


@pytest.mark.parametrize("budget_rows", [None, 60])
@pytest.mark.parametrize("kind, q", [(k, q) for k, qs in
                                     LAUNCH_QUERIES.items() for q in qs])
def test_one_launch_a_residency_batch(engines, monkeypatch, budget_rows,
                                      kind, q):
    """One sharded launch over every shard with v, or one a batch when the
    residency budget (in rows of W words) cuts the shards (the decode's 32
    rows of output a shard count against it, and the Sort's temporaries);
    shards without v are left out of their batch's table."""
    port_e = Executor(engines[1], device="cpu")
    idx = engines[1].index("b")
    v = idx.field("v").view(view_bsi_group("v"))
    shards = port_e._shards(idx, None)
    want = canon(JaxExecutor(engines[0]).execute("b", q)[0])
    old = residency.residency()
    try:
        if budget_rows is not None:
            residency.reset(budget_rows * WORDS_PER_ROW * 4)
        batches = port_e._residency_batches(
            shards, [v], 0 if kind == "gather" else
            SORT_ROWS if q.startswith("Sort") else DECODE_ROWS)
        calls = counting(monkeypatch)
        got = canon(port_e.execute("b", q)[0])
    finally:
        residency._global = old
    assert got == want
    per_batch = [sum(1 for s in b if v.fragment(s) is not None)
                 for b in batches]
    assert calls == [(kind, n) for n in per_batch if n]
    if budget_rows is None:
        assert calls == [(kind, N_SHARDS - len(NO_V))]
    else:
        assert len(calls) >= 2


def test_host_decode_past_31_makes_no_launch(engines, monkeypatch):
    """The depth-43 field takes the host decode on every route."""
    port_e = Executor(engines[1], device="cpu")
    calls = counting(monkeypatch)
    for q in (f"Distinct({UNPLANNABLE}, field=w)",
              f"Sort({UNPLANNABLE}, field=w, limit=5)",
              "Extract(Row(g=2), Rows(w))"):
        port_e.execute("b", q)
    assert calls == []
    assert decode.DEVICE_MAX_DEPTH == 31
