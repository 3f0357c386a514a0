"""Sort: the stacked sort and the keyset cursor's mask of ops/decode.py
against the JAX package, then both executors.

Module parity: seeded values and words through featurebase_tpu/ops/bsi.py
sort_bsi_stacked (two-stage top-k for cuts up to 1024, one top-k past it)
and after_mask_stacked, and through the port's decode.sort_stacked and
after_mask_stacked: heavy ties, ascending and descending, cuts 1, 7, 1024
and 1500, a filter.  Ties go to the lower column in both (the port holds
the column in its int64 key).  The cursor's column ids are int64 in the
port; the JAX package's are int32 without x64, so parity holds below 2048
shards, and the port alone is right past it (pinned against numpy).
Executor parity: limited, unlimited, offset, the `after` cursor (two pages
are one longer page), sort-desc, a filter the plan compiler refuses,
Options(shards=), a depth-43 field (host decode) and a keyed index."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.model.index import IndexOptions as JaxIndexOptions
from featurebase_tpu.ops import bsi as jbsi
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import ExecError, Executor
from featurebase_tpu_torch.ops import decode
from featurebase_tpu_torch.storage import snapshot

W = 64   # words a shard row in the module cases (2,048 columns)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("cut", [1, 7, 1024, 1500])
@pytest.mark.parametrize("spread,filtered", [(3, False), (3, True),
                                              (1 << 20, True)])
def test_sort_stacked_matches_jax(desc, cut, spread, filtered):
    rng = np.random.default_rng(cut + spread + filtered)
    S = 3
    vals = rng.integers(-spread, spread + 1, (S, 32 * W)).astype(np.int32)
    exists = words(rng, (S, W))
    filt = words(rng, (S, W)) if filtered else None
    j_idx, j_key, j_n = (np.asarray(x) for x in jbsi.sort_bsi_stacked(
        jnp.asarray(vals), jnp.asarray(exists), desc, cut,
        None if filt is None else jnp.asarray(filt)))
    idx, key, n = decode.sort_stacked(t32(vals), t32(exists), desc, cut,
                                      None if filt is None else t32(filt))
    np.testing.assert_array_equal(n.numpy(), j_n)
    for s in range(S):
        k = min(int(j_n[s]), cut)
        np.testing.assert_array_equal(idx[s, :k].numpy(), j_idx[s, :k])
        np.testing.assert_array_equal(key[s, :k].numpy(), j_key[s, :k])
        # ties to the lower column: (key, column) strictly increases
        pairs = list(zip(key[s, :k].tolist(), idx[s, :k].tolist()))
        assert pairs == sorted(pairs) and len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("desc", [False, True])
def test_sort_shard_matches_the_stacked_order(desc):
    rng = np.random.default_rng(3)
    vals = rng.integers(-4, 4, (1, 32 * W)).astype(np.int32)
    exists = words(rng, (1, W))
    idx, key, n = decode.sort_stacked(t32(vals), t32(exists), desc, 32 * W)
    cols, v = decode.sort_shard(
        t32(vals)[0], decode.expand_bits(t32(exists))[0].bool(), desc)
    k = int(n[0])
    np.testing.assert_array_equal(cols.numpy(), idx[0, :k].numpy())
    np.testing.assert_array_equal(v.numpy(),
                                  (-key if desc else key)[0, :k].numpy())


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("shards", [[0, 1, 2], [5, 900, 2047]])
def test_after_mask_matches_jax_below_2048_shards(desc, shards):
    rng = np.random.default_rng(len(shards) + desc)
    S = len(shards)
    vals = rng.integers(-5, 5, (S, 32 * W)).astype(np.int32)
    col0 = np.array(shards, dtype=np.int64) * SW
    after_col = int(col0[1]) + 700
    want = np.asarray(jbsi.after_mask_stacked(
        jnp.asarray(vals), jnp.asarray(col0), 2, after_col, desc))
    got = decode.after_mask_stacked(t32(vals), torch.from_numpy(col0), 2,
                                    after_col, desc)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_after_mask_column_ids_are_int64_past_2048_shards():
    """At shard 2048 and above a shard's first column passes 2^31: the
    port's cursor still compares the right columns (numpy oracle)."""
    rng = np.random.default_rng(9)
    shards = [2047, 2048, 5000]
    vals = rng.integers(-3, 3, (3, 32 * W)).astype(np.int32)
    col0 = np.array(shards, dtype=np.int64) * SW
    after_col = 2048 * SW + 1000
    got = decode.after_mask_stacked(t32(vals), torch.from_numpy(col0), 0,
                                    after_col, False)
    gcol = col0[:, None] + np.arange(32 * W)[None, :]
    want = (vals > 0) | ((vals == 0) & (gcol > after_col))
    np.testing.assert_array_equal(decode.expand_bits(got).bool().numpy(),
                                  want)


# ---------------------------------------------------------------------------
# Executor parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(43)
    n = 2400
    cols = np.sort(rng.choice(3 * SW, n, replace=False))
    holder = JaxHolder()
    idx = holder.create_index("s")
    idx.create_field("f")
    idx.field("f").import_bits(rng.integers(0, 4, n), cols)
    idx.create_field("v", JaxFieldOptions(type="int", min=-20, max=20))
    has_v = rng.random(n) < 0.85
    idx.field("v").import_values(cols[has_v],
                                 rng.integers(-20, 21, int(has_v.sum())))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2,
                                          min=-50, max=50))
    idx.field("d").import_values(cols, np.round(rng.uniform(-50, 50, n), 2))
    top = (1 << 43) - 1
    idx.create_field("w", JaxFieldOptions(type="int", min=-top, max=top))
    idx.field("w").import_values(cols, rng.integers(-9, 9, n) * (1 << 38))
    idx.mark_exists(cols)
    kidx = holder.create_index("k", JaxIndexOptions(keys=True))
    kidx.create_field("n", JaxFieldOptions(type="int", min=0, max=100))
    keys = [f"rec{i}" for i in range(40)]
    ids = kidx.translate_store.create_keys(keys)
    kcols = np.array([ids[k] for k in keys], dtype=np.int64)
    kidx.field("n").import_values(kcols, rng.integers(0, 10, 40))
    kidx.mark_exists(kcols)
    path = str(tmp_path_factory.mktemp("sort") / "holder")
    jax_snapshot.save(holder, path)
    return JaxExecutor(holder), Executor(snapshot.load(path), device="cpu")


EXEC_QUERIES = [
    "Sort(All(), field=v, limit=10)",
    "Sort(All(), field=v, sort-desc=true, limit=10)",
    "Sort(Row(f=1), field=v, limit=25, offset=7)",
    "Sort(Row(f=2), field=v, sort-desc=true, limit=5, offset=3)",
    "Sort(Row(f=3), field=v)",
    "Sort(field=v, limit=4)",
    "Sort(All(), field=v, limit=5000)",
    "Sort(All(), field=v, limit=8, after=[3, 1500000])",
    "Sort(All(), field=v, sort-desc=true, limit=8, after=[-2, 100])",
    "Sort(Row(f=1), field=v, after=[0, 2200000])",
    "Sort(Union(Row(f=null), Row(f=2)), field=v, limit=12)",
    "Sort(Union(Row(f=null), Row(f=2)), field=v, sort-desc=true, "
    "limit=6, after=[5, 0])",
    "Sort(All(), field=d, limit=9)",
    "Sort(Row(f=0), field=d, sort-desc=true, limit=9, offset=2)",
    "Sort(All(), field=w, limit=11)",
    "Sort(Row(f=1), field=w, sort-desc=true, limit=6, after=[0, 0])",
    "Sort(Row(f=2), field=w)",
    "Options(Sort(All(), field=v, limit=6), shards=[0, 2])",
    # chip_smoke.py's
    "Sort(Row(f=1), field=v, limit=10)",
    "Sort(All(), field=v, sort-desc=true, limit=5, offset=3)",
]


@pytest.mark.parametrize("query", EXEC_QUERIES)
def test_executor_sort_matches_jax(engines, query):
    jax_e, port_e = engines
    assert port_e.execute("s", query)[0] == jax_e.execute("s", query)[0]


@pytest.mark.parametrize("desc", ["false", "true"])
def test_cursor_pages_join_into_one_page(engines, desc):
    _, port_e = engines
    whole = port_e.execute("s", f"Sort(All(), field=v, sort-desc={desc}, "
                                "limit=20)")[0]
    first = port_e.execute("s", f"Sort(All(), field=v, sort-desc={desc}, "
                                "limit=8)")[0]
    v, c = first["values"][-1], first["columns"][-1]
    second = port_e.execute("s", f"Sort(All(), field=v, sort-desc={desc}, "
                                 f"limit=12, after=[{v}, {c}])")[0]
    assert first["columns"] + second["columns"] == whole["columns"]


@pytest.mark.parametrize("desc", [False, True])
def test_ties_go_to_the_lower_column(engines, desc):
    """Against a numpy order of the same records: the value, then the
    lower column first, ascending or descending."""
    _, port_e = engines
    f = port_e.holder.index("s").field("v")
    rows = []
    for shard in range(3):
        vals, ex = f.values_dense_host(shard)
        cols = np.nonzero(ex)[0]
        rows += [(int(vals[c]) + f.base, shard * SW + int(c)) for c in cols]
    rows.sort(key=lambda r: ((-r[0] if desc else r[0]), r[1]))
    got = port_e.execute("s", f"Sort(All(), field=v, sort-desc="
                              f"{'true' if desc else 'false'}, limit=300)")[0]
    assert got["columns"] == [c for _, c in rows[:300]]
    assert got["values"] == [v for v, _ in rows[:300]]


def test_keyed_index_sorts_to_record_keys(engines):
    jax_e, port_e = engines
    q = "Sort(All(), field=n, sort-desc=true, limit=12)"
    got = port_e.execute("k", q)[0]
    assert got == jax_e.execute("k", q)[0]
    assert all(isinstance(c, str) for c in got["columns"])


def test_sort_needs_an_int_field(engines):
    _, port_e = engines
    with pytest.raises(ExecError, match="int-like"):
        port_e.execute("s", "Sort(All(), field=f)")
