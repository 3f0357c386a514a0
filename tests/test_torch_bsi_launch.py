"""Kernels C' and D' over every shard's BSI mirrors in one launch.

First the plain versions of the sharded forms (bsi_sum_planes_sharded,
bsi_min_max_sharded; the wrappers take them on CPU tensors) against the JAX
package's sum_planes_stacked, sum_host, min_max_stacked and
min_host/max_host over the same numpy groups (made from a seed): per-shard
groups given as a fragment-like tile with a slot for each plane (rows out
of order, spare rows, absent planes at -1) or as a (D + 2, W) view, a shard
without data, filter rows that are None, depths 1 to 63, an odd W, sign-set
zeros and ties across shards, Min and Max.  The reference sees the same
bits with every absent plane, shard and filter row as zeros.  Then Sum, Min
and Max under filters the plan compiler refuses (Union(Row(g=1),
Row(f=null)), Row(g=null)) through both executors, on an index where two
shards lack one BSI field and a second field is 43 planes deep; and the
launches: one sharded launch per residency batch, with and without a small
budget.  Answers are integers: the tolerance is zero.  The CUDA kernels are
held against these plain versions on the card by chip_smoke.py."""
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
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.model.view import view_bsi_group
from featurebase_tpu_torch.ops import bsi
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.parallel.agg import finalize_sum
from featurebase_tpu_torch.storage import residency, snapshot

S = 5
ABSENT_SHARD, NO_FILTER_ROW, NO_SIGN, VIEWED = 1, 3, 2, 4
DEPTHS = (1, 14, 31, 32, 43, 63)
KINDS = ("values", "sign_zero_ties")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pack(bits: np.ndarray) -> np.ndarray:
    """(..., C) bool -> (..., C / 32) uint32 words (column c at word c / 32,
    bit c % 32)."""
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def make_shards(depth: int, W: int, kind: str):
    """The port's per-shard inputs and the reference's stacked view of the
    same bits: (groups, filter rows, filter words, ref group (S, D + 2, W)
    uint32, ref filter (S, W) uint32).  Shard ABSENT_SHARD has no data,
    NO_FILTER_ROW no filter row (None), NO_SIGN no sign plane; a fifth of
    the magnitude planes are absent; shard VIEWED is a (D + 2, W) view, the
    others a tile of their present planes in random order with two spare
    rows and a slot a plane."""
    rng = np.random.default_rng([depth, W, KINDS.index(kind)])
    C = 32 * W
    top = 4 if kind == "sign_zero_ties" else 1 << min(depth, 62)
    mag = rng.integers(0, top, size=(S, C), dtype=np.uint64)
    if depth == 63:   # the top plane too
        mag |= rng.integers(0, 2, size=(S, C), dtype=np.uint64) << \
            np.uint64(62)
    neg = rng.random((S, C)) < 0.5
    ex = rng.random((S, C)) < 0.6
    filt = rng.random((S, C)) < 0.7
    if kind == "sign_zero_ties":
        mag[rng.random((S, C)) < 0.3] = 0     # sign-set zeros among them
        mag[2], neg[2], ex[2], filt[2] = mag[0], neg[0], ex[0], filt[0]
    planes = [ex, ex & neg] + [ex & (((mag >> np.uint64(d)) & np.uint64(1))
                                     == 1) for d in range(depth)]
    ref = np.stack([pack(p) for p in planes], axis=1)    # (S, D + 2, W)
    ref_filt = pack(filt)
    absent = rng.random((S, depth + 2)) < 0.2
    absent[:, 0] = False
    absent[NO_SIGN, 1] = True
    absent[ABSENT_SHARD] = True
    ref[absent] = 0
    ref_filt[NO_FILTER_ROW] = 0
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
    rows = [None if s == NO_FILTER_ROW else t(ref_filt[s]) for s in range(S)]
    return groups, rows, t(ref_filt), ref, ref_filt


def cases():
    for depth in DEPTHS:
        for W in (64, 1001):
            for kind in KINDS:
                yield depth, W, kind


CASES = list(cases())


@pytest.mark.parametrize("depth, W, kind", CASES)
@pytest.mark.parametrize("filter_as", ("rows", "words"))
def test_sharded_sum_matches_jax(depth, W, kind, filter_as):
    groups, rows, words, ref, ref_filt = make_shards(depth, W, kind)
    parts = ck.bsi_sum_planes_sharded(
        groups, rows if filter_as == "rows" else words).numpy()
    pp, nn, cnt = jbsi.sum_planes_stacked(ref, ref_filt)
    np.testing.assert_array_equal(parts[:depth], np.asarray(pp))
    np.testing.assert_array_equal(parts[depth:2 * depth], np.asarray(nn))
    assert parts[2 * depth] == int(cnt)
    assert torch.equal(torch.from_numpy(parts),
                       bsi.sum_planes_plain(t(ref), t(ref_filt)))
    total = finalize_sum(parts[:depth], parts[depth:2 * depth])
    want = [jbsi.sum_host(ref[s, 2:], ref[s, 0], ref[s, 1], ref_filt[s],
                          depth) for s in range(S)]
    assert (total, int(parts[2 * depth])) == \
        (sum(v for v, _ in want), sum(c for _, c in want))


@pytest.mark.parametrize("depth, W, kind", CASES)
@pytest.mark.parametrize("is_min", (True, False))
def test_sharded_min_max_matches_jax(depth, W, kind, is_min):
    groups, rows, _, ref, ref_filt = make_shards(depth, W, kind)
    parts = ck.bsi_min_max_sharded(groups, rows, is_min)
    assert torch.equal(parts, bsi.min_max_parts_plain(t(ref), t(ref_filt),
                                                      is_min))
    parts = parts.numpy()
    host = jbsi.min_host if is_min else jbsi.max_host
    want = [host(ref[s, 2:], ref[s, 0], ref[s, 1], ref_filt[s], depth)
            for s in range(S)]
    assert bsi.min_max_per_shard(parts, is_min) == \
        [(int(v), int(c)) for v, c in want]
    if depth <= 31:
        v, c = jbsi.min_max_stacked(ref, ref_filt, depth, is_min)
        assert bsi.min_max_stacked_finish(parts, is_min) == \
            ((int(v), int(c)) if int(c) else (0, 0))


def test_sharded_edge_shapes():
    """No shard with data, one shard, and groups as plain (D + 2, W)
    tensors beside the stacked wrappers."""
    groups, rows, words, ref, ref_filt = make_shards(14, 64, "values")
    none = [None] * S
    assert not ck.bsi_sum_planes_sharded(none, rows).any()
    assert torch.equal(ck.bsi_min_max_sharded(none, rows, True),
                       torch.zeros((S, 4, 2), dtype=torch.int64))
    stacked = [t(ref[s]) for s in range(S)]
    for is_min in (True, False):
        assert torch.equal(ck.bsi_min_max_sharded(stacked, words, is_min),
                           ck.bsi_min_max(t(ref), t(ref_filt), is_min))
        assert torch.equal(ck.bsi_min_max_sharded(stacked[:1], words[:1],
                                                  is_min),
                           ck.bsi_min_max(t(ref[:1]), t(ref_filt[:1]),
                                          is_min))
    assert torch.equal(ck.bsi_sum_planes_sharded(stacked, words),
                       ck.bsi_sum_planes(t(ref), t(ref_filt)))


def test_sharded_wrappers_validate_inputs():
    groups, rows, words, _, _ = make_shards(14, 64, "values")
    mixed = list(groups)
    mixed[0] = (groups[0][0], groups[0][1][:-1])      # one plane short
    with pytest.raises(ValueError):
        ck.bsi_sum_planes_sharded(mixed, rows)
    with pytest.raises(ValueError):
        ck.bsi_min_max_sharded(groups, None, True)
    with pytest.raises(ValueError):
        ck.bsi_min_max_sharded(groups, words[:, :32], False)


# -- through the executors ----------------------------------------------------

N_SHARDS, N_RECORDS = 6, 3000
NO_V = (2, 4)          # shards without field v
W_DEPTH = 43


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """f, g: set fields (f on 70% of the records, g rows 0-3 on 80%); v: int
    in [-500, 9000], none in shards 2 and 4, -500 in shards 0, 3 and 5 and
    9000 in shards 0 and 5 (ties across shards); w: int at depth 43, half
    negative."""
    rng = np.random.default_rng(47)
    cols = np.sort(rng.choice(N_SHARDS * SW, size=N_RECORDS, replace=False))
    shard = cols // SW
    holder = JaxHolder()
    idx = holder.create_index("b")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", JaxFieldOptions(type="int", min=-500, max=9000))
    idx.create_field("w", JaxFieldOptions(type="int", min=-(1 << 42),
                                          max=(1 << 42)))
    has_f = rng.random(N_RECORDS) < 0.7
    idx.field("f").import_bits(rng.integers(0, 5, int(has_f.sum())),
                               cols[has_f])
    has_g = rng.random(N_RECORDS) < 0.8
    idx.field("g").import_bits(rng.integers(0, 4, int(has_g.sum())),
                               cols[has_g])
    has_v = (rng.random(N_RECORDS) < 0.85) & ~np.isin(shard, NO_V)
    vals = rng.integers(-499, 8999, N_RECORDS)
    for s, val in ((0, -500), (3, -500), (5, -500), (0, 9000), (5, 9000)):
        at = np.flatnonzero((shard == s) & has_v)
        vals[at[:2] if val < 0 else at[2:4]] = val
    idx.field("v").import_values(cols[has_v], vals[has_v])
    has_w = rng.random(N_RECORDS) < 0.6
    idx.field("w").import_values(
        cols[has_w], rng.integers(-(1 << 42), 1 << 42, int(has_w.sum())))
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("bsi") / "holder")
    jax_snapshot.save(holder, path)
    return holder, snapshot.load(path)


FILTERS = ("Union(Row(g=1), Row(f=null))", "Row(g=null)")
QUERIES = [f"{agg}({filt}, field={fld})" for filt in FILTERS
           for fld in ("v", "w") for agg in ("Sum", "Min", "Max")] + [
    "Options(Min(Row(g=null), field=v), shards=[2, 4])",
    "Options(Max(Union(Row(g=1), Row(f=null)), field=v), shards=[0, 5])",
    "Options(Sum(Union(Row(g=1), Row(f=null)), field=v), shards=[1, 2, 3])",
]


def answer(executor, q):
    r = executor.execute("b", q)[0]
    return r.val, r.count


@pytest.mark.parametrize("q", QUERIES)
def test_unplannable_filters_match_jax(engines, q):
    jax_e, port_e = JaxExecutor(engines[0]), Executor(engines[1],
                                                      device="cpu")
    assert answer(port_e, q) == answer(jax_e, q)


@pytest.mark.parametrize("agg, want", (("Min", (-500, 6)),
                                       ("Max", (9000, 4))))
def test_min_max_ties_across_shards(engines, agg, want):
    """Every record, under a filter the plan compiler refuses: the extreme
    value in two records of each of three (two) shards adds their counts."""
    q = f"{agg}(Union(Row(g=null), Row(g=0), Row(g=1), Row(g=2), " \
        f"Row(g=3)), field=v)"
    assert answer(Executor(engines[1], device="cpu"), q) == \
        answer(JaxExecutor(engines[0]), q) == want


def counting(monkeypatch):
    """Fake sharded wrappers that record each launch's shard count and run
    the plain versions."""
    calls = []
    real_sum, real_mm = ck.bsi_sum_planes_sharded, ck.bsi_min_max_sharded

    def fake_sum(groups, filt):
        calls.append(("sum", len(groups)))
        return real_sum(groups, filt)

    def fake_mm(groups, filt, is_min):
        calls.append(("min" if is_min else "max", len(groups)))
        return real_mm(groups, filt, is_min)
    monkeypatch.setattr(ck, "bsi_sum_planes_sharded", fake_sum)
    monkeypatch.setattr(ck, "bsi_min_max_sharded", fake_mm)
    return calls


@pytest.mark.parametrize("budget_rows", [None, 40])
@pytest.mark.parametrize("agg", ("Sum", "Min", "Max"))
def test_one_launch_a_residency_batch(engines, monkeypatch, budget_rows,
                                      agg):
    """One sharded launch over every shard with v, or one a batch when the
    residency budget (in rows of W words) cuts the shards; shards without v
    are left out of their batch's table."""
    port_e = Executor(engines[1], device="cpu")
    idx = engines[1].index("b")
    v = idx.field("v").view(view_bsi_group("v"))
    shards = port_e._shards(idx, None)
    q = f"{agg}(Union(Row(g=1), Row(f=null)), field=v)"
    want = answer(JaxExecutor(engines[0]), q)
    old = residency.residency()
    try:
        if budget_rows is not None:
            residency.reset(budget_rows * WORDS_PER_ROW * 4)
        batches = port_e._residency_batches(shards, [v])
        calls = counting(monkeypatch)
        got = answer(port_e, q)
    finally:
        residency._global = old
    assert got == want
    per_batch = [sum(1 for s in b if v.fragment(s) is not None)
                 for b in batches]
    kind = {"Sum": "sum", "Min": "min", "Max": "max"}[agg]
    assert calls == [(kind, n) for n in per_batch if n]
    if budget_rows is None:
        assert calls == [(kind, N_SHARDS - len(NO_V))]
    else:
        assert len(calls) >= 2
