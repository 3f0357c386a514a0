"""Kernels E and F over every shard in one launch, operands read in place.

pair_counts_sharded and bsi_sum_groups_sharded (ops/cuda_kernels.py) take
each shard's rows where they live: per-shard tiles (a fragment's device
mirror) and a slot table with -1 for a row the shard lacks.  Their plain
versions (what the wrappers run on CPU tensors) must equal the JAX
package's stacked_pair_counts and sum_groups_stacked over the same words,
stacked, at W = 32768: absent rows, a shard with no tile or no BSI data,
with and without a filter, one to three dimensions, D in {1, 14, 31, 32,
63}.  Then the executor's one-launch GroupBy (_group_by_launch) against the
JAX executor, exactly, with the caps lowered so that it is taken and raised
so that the stacked path is, and under a residency budget that cuts the
shards into batches."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.ops import bitwise as jbw
from featurebase_tpu.ops import bsi as jbsi
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.core.consts import WORDS_PER_ROW as W
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.pql.parser import parse
from featurebase_tpu_torch.storage import residency, snapshot

S = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def dimension(rng, n: int, absent: bool = True):
    """Per-shard tiles holding n rows (and two spare ones) in shuffled
    slots, and the (S, n) slot table; with `absent`, shard 1 has no tile
    and about one row in four is missing.  Also the (S, n, W) stacked words
    of the same rows (zeros where absent)."""
    tiles, slots = [], np.full((S, n), -1, dtype=np.int64)
    stacked = np.zeros((S, n, W), dtype=np.uint32)
    for s in range(S):
        if absent and s == 1:
            tiles.append(None)
            continue
        host = words(rng, (n + 2, W))
        tiles.append(t(host))
        slots[s] = rng.permutation(n + 2)[:n]
        if absent:
            slots[s, rng.random(n) < 0.25] = -1
        for i, sl in enumerate(slots[s]):
            if sl >= 0:
                stacked[s, i] = host[sl]
    return (tiles, slots), stacked


def jax_masks(stacked_dims, filt):
    """The group masks of the stacked dimensions (itertools order, the last
    fastest) [& filter], with the JAX package's own ops."""
    m = jnp.asarray(stacked_dims[0])
    for d in stacked_dims[1:]:
        m = jbw.stacked_all_pairs_and(m, jnp.asarray(d))
    return m if filt is None else jbw.stacked_mask_filter(m, jnp.asarray(filt))


def filters(rng, kind: str):
    """(the filter as the port takes it, its (S, W) words or None)."""
    if kind == "none":
        return None, None
    f = words(rng, (S, W))
    if kind == "words":
        return t(f), f
    f[2] = 0   # per-shard rows, shard 2's missing
    return [t(f[s]) if s != 2 else None for s in range(S)], f


@pytest.mark.parametrize("sizes", [(8, 4), (3, 2, 4), (1, 8), (8, 1)])
@pytest.mark.parametrize("filt", ["none", "words", "rows"])
def test_pair_counts_sharded_matches_jax(sizes, filt):
    rng = np.random.default_rng(sum(sizes) * 7 + len(filt))
    dims = [dimension(rng, n, absent=i != 1) for i, n in enumerate(sizes)]
    port_f, host_f = filters(rng, filt)
    (mt, ms), *mid, (rt, rs) = [d for d, _ in dims]
    got = ck.pair_counts_sharded(mt, ms, rt, rs, port_f,
                                 mid[0] if mid else None)
    masks = jax_masks([s for _, s in dims[:-1]], host_f)
    want = np.asarray(jbw.stacked_pair_counts(masks,
                                              jnp.asarray(dims[-1][1])))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def bsi_group(rng, depth: int) -> np.ndarray:
    """(D + 2, W): exists on most columns, signs on some, random planes
    under exists."""
    g = words(rng, (depth + 2, W))
    g[0] |= words(rng, (W,))
    g[1] &= g[0]
    g[2:] &= g[0][None]
    return g


@pytest.mark.parametrize("depth", [1, 14, 31, 32, 63])
@pytest.mark.parametrize("sizes,filt", [((8,), "words"), ((4, 2), "none"),
                                        ((2, 2, 2), "rows")])
def test_bsi_sum_groups_sharded_matches_jax(depth, sizes, filt):
    rng = np.random.default_rng(depth * 31 + len(sizes))
    dims = [dimension(rng, n) for n in sizes]
    port_f, host_f = filters(rng, filt)
    groups = [bsi_group(rng, depth) if s != 3 else None for s in range(S)]
    got = ck.bsi_sum_groups_sharded(
        [None if g is None else t(g) for g in groups], [d for d, _ in dims],
        port_f)
    stacked = np.stack([g if g is not None else
                        np.zeros((depth + 2, W), dtype=np.uint32)
                        for g in groups])
    masks = jax_masks([s for _, s in dims], host_f)
    pos, neg, cnt = jbsi.sum_groups_stacked(jnp.asarray(stacked), masks,
                                            depth)
    want = np.concatenate([np.asarray(pos), np.asarray(neg),
                           np.asarray(cnt)[:, None]], axis=1)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_stacked_wrappers_are_the_same_product():
    """pair_counts and bsi_sum_groups over stacked operands equal the
    sharded product over the same rows."""
    rng = np.random.default_rng(5)
    (mt, ms), m_st = dimension(rng, 6, absent=False)
    (rt, rs), r_st = dimension(rng, 3, absent=False)
    f = t(words(rng, (S, W)))
    np.testing.assert_array_equal(
        ck.pair_counts(t(m_st), t(r_st), f).numpy(),
        ck.pair_counts_sharded(mt, ms, rt, rs, f).numpy())
    groups = [t(bsi_group(rng, 14)) for _ in range(S)]
    masks = t(m_st) & f[:, None, :]
    np.testing.assert_array_equal(
        ck.bsi_sum_groups(torch.stack(groups), masks).numpy(),
        ck.bsi_sum_groups_sharded(groups, [(mt, ms)], f).numpy())


def test_row_addresses():
    """The row-address table: tile s's row at slots[s, i], 0 for a missing
    row or shard; stacked tensors by their strides, views included."""
    base = torch.zeros((5, 8), dtype=torch.int32)
    view = torch.zeros((3, 9), dtype=torch.int32)[:, 1:]
    slots = np.array([[4, -1, 0], [0, 1, 2], [2, 2, -1]])
    got = ck._dim_addrs([base, None, view], slots, 8, "d")
    p, v = base.data_ptr(), view.data_ptr()
    assert got.tolist() == [[p + 128, 0, p], [0, 0, 0],
                            [v + 72, v + 72, 0]]
    with pytest.raises(ValueError, match="past its tile"):
        ck._dim_addrs([base, None, view], np.array([[5, 0, 0]] * 3), 8, "d")
    stacked = torch.zeros((2, 3, 8), dtype=torch.int32)[:, 1:]
    a = ck._stacked_addrs(stacked)
    assert a.tolist() == [[stacked[s, r].data_ptr() for r in range(2)]
                          for s in range(2)]


# -- the executor's one-launch GroupBy ----------------------------------------

N_SHARDS, N_RECORDS = 4, 2000


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(41)
    cols = np.sort(rng.choice(N_SHARDS * SW, size=N_RECORDS, replace=False))
    # shard 3 holds no f, v or h: a shard without a fragment or BSI data
    in3 = cols // SW == 3
    holder = JaxHolder()
    idx = holder.create_index("g")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("h")
    idx.create_field("v", JaxFieldOptions(type="int", min=-500, max=9000))
    idx.field("f").import_bits(rng.integers(0, 5, int((~in3).sum())),
                               cols[~in3])
    has_g = rng.random(N_RECORDS) < 0.8
    idx.field("g").import_bits(rng.integers(0, 4, int(has_g.sum())),
                               cols[has_g])
    idx.field("h").import_bits(rng.integers(0, 3, int((~in3).sum())),
                               cols[~in3])
    has_v = (rng.random(N_RECORDS) < 0.85) & ~in3
    idx.field("v").import_values(cols[has_v],
                                 rng.integers(-500, 9000, int(has_v.sum())))
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("launch") / "holder")
    jax_snapshot.save(holder, path)
    return holder, snapshot.load(path)


QUERIES = [
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), Rows(g), having=Condition(count > 30))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "GroupBy(Rows(f), aggregate=Sum(field=v))",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
    "GroupBy(Rows(f), Rows(g), Rows(h), aggregate=Sum(field=v))",
    "GroupBy(Rows(g), Rows(h), filter=Row(f=null))",
    "GroupBy(Rows(g), Rows(h), aggregate=Sum(field=v), filter=Row(f=null))",
    "GroupBy(Rows(f), Rows(g), filter=Row(v > 3000))",
    "GroupBy(Rows(g, in=[1, 3]), Rows(f), aggregate=Sum(field=v), "
    "having=Condition(sum > 100000))",
    "Options(GroupBy(Rows(f), Rows(h)), shards=[0, 3])",
]


def norm(result):
    return [(tuple(fr.row_id for fr in gc.group), gc.count, gc.agg)
            for gc in result]


def one_shard_bytes(port_e, q: str) -> int:
    """A mask cap that one shard's one-shot product meets and the stacked
    path (every shard's masks at once) does not."""
    call = parse(q).calls[0]
    while call.name == "Options":
        call = call.children[0]
    idx = port_e.holder.index("g")
    rows = [len(port_e._execute_rows(idx, rc, None, verify_nonempty=False))
            for rc in call.children if rc.name == "Rows"]
    need = int(np.prod(rows if "Sum" in q else rows[:-1]))
    return max(need, 1) * W * 4


def run(engines, q: str, lowered: bool):
    """Both executors' answers, the caps lowered (one launch; per shard in
    the JAX package) or left (stacked), and whether the port launched."""
    jax_e = JaxExecutor(engines[0])
    port_e = Executor(engines[1], device="cpu")
    if lowered:
        cap = one_shard_bytes(port_e, q)
        for e in (jax_e, port_e):
            e.GROUPBY_ONESHOT_MAX_MASK_BYTES = cap
    seen = []
    real = port_e._group_by_launch

    def spy(*a):
        r = real(*a)
        seen.append(r)
        return r
    port_e._group_by_launch = spy
    want = jax_e.execute("g", q)[0]
    got = port_e.execute("g", q)[0]
    assert norm(got) == norm(want), q
    return seen


@pytest.mark.parametrize("q", QUERIES)
def test_group_by_one_launch_matches_jax(engines, q):
    seen = run(engines, q, lowered=True)
    if "null" not in q:   # an unplannable filter skips the stacked path
        assert seen == [True], q


@pytest.mark.parametrize("q", QUERIES)
def test_group_by_stacked_matches_jax(engines, q):
    seen = run(engines, q, lowered=False)
    assert seen == [] or "null" in q


def test_group_by_in_residency_batches(engines):
    """A budget below every shard's mirrors cuts the shards into batches,
    one launch each; the answers stay the same."""
    calls = []
    real_e, real_f = ck.pair_counts_sharded, ck.bsi_sum_groups_sharded

    def spy(real):
        def f(*a, **k):
            calls.append(len(a[0]))
            return real(*a, **k)
        return f
    ck.pair_counts_sharded = spy(real_e)
    ck.bsi_sum_groups_sharded = spy(real_f)
    old = residency.residency()
    try:
        residency.reset(12 * W * 4)   # about one shard of f and g
        for q in ("GroupBy(Rows(f), Rows(g))",
                  "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))"):
            calls.clear()
            run(engines, q, lowered=True)
            assert len(calls) >= 2 and all(n == 1 for n in calls), calls
    finally:
        ck.pair_counts_sharded, ck.bsi_sum_groups_sharded = real_e, real_f
        residency._global = old
