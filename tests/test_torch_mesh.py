"""The port's mesh (featurebase_tpu_torch.parallel) against the JAX
package's, on CPU members.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's members are CPU devices named eight times, so every kernel takes its
plain version.  Compared exactly:

- the eight programs of parallel/agg.py against featurebase_tpu's on the
  same seeded words, at S = 8 and at S = 5 (padded to 8);
- every family that the JAX dry run asserts, and more, through
  Executor(mesh=) on 1, 2 and 8 members against the JAX Executor(mesh=
  make_mesh(n)) over the same holder at n + 3 shards, also with the
  GroupBy caps at 0 (the level-wise mesh GroupBy);
- the port's dryrun_multichip(n) for n = 1, 2, 4 and 8;
- a one-member mesh against no mesh over the same mix;
- one kernel call a member for each family's stacked route;
- the counterparts of tests/test_plan_parallel.py's
  test_mesh_sharded_execution and test_shard_device_deterministic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.model.index import IndexOptions as JaxIndexOptions
from featurebase_tpu.parallel import agg as jagg
from featurebase_tpu.parallel.mesh import make_mesh as jax_make_mesh
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.parallel import agg
from featurebase_tpu_torch.parallel.dryrun import dryrun_multichip
from featurebase_tpu_torch.parallel.mesh import (Mesh, make_mesh,
                                                 shard_device,
                                                 shards_by_device)
from featurebase_tpu_torch.storage import snapshot

W = 256   # words a row of the agg programs' operands (any width runs)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int) -> Mesh:
    return make_mesh(devices=["cpu"] * n)


# -- the eight agg programs -------------------------------------------------

def _words(rng, *shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def _bsi(rng, S: int, D: int) -> np.ndarray:
    """A BSI group whose planes lie under exists (as real groups do)."""
    g = _words(rng, S, D + 2, W)
    g[:, 1:] &= g[:, :1]
    return g


def _padded(host: np.ndarray, n: int = 8) -> np.ndarray:
    pad = (-host.shape[0]) % n
    return np.concatenate([host, np.zeros((pad,) + host.shape[1:],
                                          host.dtype)]) if pad else host


def _jput(host: np.ndarray):
    spec = P("shards", *([None] * (host.ndim - 1)))
    return jax.device_put(_padded(host), NamedSharding(jax_make_mesh(8),
                                                       spec))


@pytest.fixture(scope="module", params=[8, 5], ids=["S8", "S5_padded"])
def operands(request):
    S = request.param
    rng = np.random.default_rng(100 + S)
    host = dict(words=_words(rng, S, W), filt=_words(rng, S, W),
                tiles=_words(rng, S, 6, W), masks=_words(rng, S, 4, W),
                bsi=_bsi(rng, S, 9), gmasks=_words(rng, S, 5, W))
    mesh = cpu_mesh(8)
    return (mesh, {k: mesh.put(v) for k, v in host.items()},
            jax_make_mesh(8), {k: _jput(v) for k, v in host.items()})


def test_total_count(operands):
    mesh, t, jmesh, j = operands
    assert agg.total_count(mesh, t["words"]) == \
        jagg.total_count(jmesh, j["words"])


def test_row_counts(operands):
    mesh, t, jmesh, j = operands
    np.testing.assert_array_equal(
        agg.row_counts(mesh, t["tiles"], t["filt"]).numpy(),
        np.asarray(jagg.row_counts(jmesh, j["tiles"], j["filt"])))


def test_pair_counts(operands):
    mesh, t, jmesh, j = operands
    np.testing.assert_array_equal(
        agg.pair_counts(mesh, t["masks"], t["tiles"]).numpy(),
        np.asarray(jagg.pair_counts(jmesh, j["masks"], j["tiles"])))


def test_sum_planes(operands):
    mesh, t, jmesh, j = operands
    got = agg.sum_planes(mesh, t["bsi"], t["filt"])
    want = jagg.sum_planes(jmesh, j["bsi"], j["filt"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert agg.finalize_sum(got[0].numpy(), got[1].numpy()) == \
        jagg.finalize_sum(want[0], want[1])


def test_group_sums(operands):
    mesh, t, jmesh, j = operands
    got = agg.group_sums(mesh, t["gmasks"], t["bsi"])
    want = jagg.group_sums(jmesh, j["gmasks"], j["bsi"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gather_and(operands):
    mesh, t, jmesh, j = operands
    fi, rj = np.array([0, 3, 3, 1]), np.array([5, 0, 2, 2])
    got = agg.gather_and(mesh, t["masks"], t["tiles"], fi, rj)
    want = jagg.gather_and(jmesh, j["masks"], j["tiles"],
                           jnp.asarray(fi, dtype=jnp.int32),
                           jnp.asarray(rj, dtype=jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mask_filter(operands):
    mesh, t, jmesh, j = operands
    np.testing.assert_array_equal(
        agg.mask_filter(mesh, t["tiles"], t["filt"]).numpy(),
        np.asarray(jagg.mask_filter(jmesh, j["tiles"], j["filt"])))


def test_take_rows(operands):
    mesh, t, jmesh, j = operands
    keep = np.array([2, 0])
    np.testing.assert_array_equal(
        agg.take_rows(mesh, t["masks"], keep).numpy(),
        np.asarray(jagg.take_rows(jmesh, j["masks"],
                                  jnp.asarray(keep, dtype=jnp.int32))))


def test_sharded_layout():
    """S_pad = S + (-S) % n, contiguous equal blocks in shard-list order,
    padding rows zero."""
    mesh = cpu_mesh(4)
    host = np.arange(5 * 3, dtype=np.uint32).reshape(5, 3) + 1
    sh = mesh.put(host)
    assert (sh.S, sh.S_pad, sh.block_rows) == (5, 8, 2)
    assert sh.shards == [0, 1, 2, 3, 4, -1, -1, -1]
    assert [sh.shards_of(k) for k in range(4)] == \
        [[0, 1], [2, 3], [4, -1], [-1, -1]]
    np.testing.assert_array_equal(sh.numpy(), _padded(host, 4))


# -- the engine on a mesh against the JAX package's -------------------------

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


# the JAX dry run's families first, then filters, three dimensions, a
# filter the plan compiler refuses (the per-shard route) and more
MIX = [
    "Count(Intersect(Row(f=1), Row(n > 0)))",
    "Sum(field=n)",
    "Min(field=n)",
    "Max(field=n)",
    "TopN(f)",
    "GroupBy(Rows(f), Rows(g))",
    "GroupBy(Rows(f), aggregate=Sum(field=n))",
    "Rows(f)",
    "Distinct(field=g)",
    "Distinct(field=n)",
    "Sort(All(), field=n, limit=3)",
    "Percentile(field=n, nth=50)",
    "Extract(Row(f=1), Rows(n))",
    "dryk:Count(Row(kf=1))",
    "dryk:Extract(All(), Rows(kf))",
    "Row(f=2)",
    "Count(Not(Row(g=1)))",
    "Count(Shift(Row(f=3), n=2))",
    "TopN(f, Row(g=1), n=3)",
    "Sum(Row(f=1), field=n)",
    "Min(Row(g=2), field=n)",
    "Max(Row(n < 500), field=n)",
    "GroupBy(Rows(f), Rows(g), Rows(h))",
    "GroupBy(Rows(g), Rows(f), aggregate=Sum(field=n), filter=Row(h=1))",
    "Distinct(Row(f=0), field=n)",
    "Distinct(Row(n > 400), field=g)",
    "Sort(Row(g=1), field=n, sort-desc=true, limit=4, offset=2)",
    "Percentile(field=n, nth=90, filter=Row(f=2))",
    "Extract(Limit(Row(g=0), limit=30), Rows(f), Rows(n))",
    "Count(Union(Row(f=1), Row(f=null)))",
    "Sum(Union(Row(g=1), Row(f=null)), field=n)",
    "TopN(f, Union(Row(g=0), Row(f=null)), n=2)",
    "Options(Count(Row(f=1)), shards=[0, 2])",
    "Options(Sum(field=n), shards=[1])",
]
LEVELWISE = ["GroupBy(Rows(f), Rows(g))",
             "GroupBy(Rows(f), Rows(g), Rows(h))",
             "GroupBy(Rows(g), aggregate=Sum(field=n), filter=Row(f=1))",
             "GroupBy(Rows(g), Rows(h), aggregate=Sum(field=n))"]


def _split(q: str):
    return ("dryk", q[5:]) if q.startswith("dryk:") else ("mix", q)


@pytest.fixture(scope="module")
def holders(tmp_path_factory):
    """A JAX holder at 11 shards (n + 3 for 8 members) with a keyed index,
    saved and loaded into the port."""
    rng = np.random.default_rng(15)
    n = 2500
    cols = np.sort(rng.choice(11 * SW, n, replace=False))
    holder = JaxHolder()
    idx = holder.create_index("mix")
    for name, rows in (("f", 5), ("g", 3), ("h", 2)):
        idx.create_field(name)
        idx.field(name).import_bits(rng.integers(0, rows, n), cols)
    idx.create_field("n", JaxFieldOptions(type="int", min=-50, max=1000))
    has = rng.random(n) < 0.8
    idx.field("n").import_values(cols[has],
                                 rng.integers(-50, 1000, int(has.sum())))
    idx.mark_exists(cols)
    kidx = holder.create_index("dryk", JaxIndexOptions(keys=True))
    kidx.create_field("kf")
    kmap = kidx.translate_store.create_keys(["alice", "bob", "carol"])
    kcols = np.array([kmap["alice"], kmap["bob"], kmap["carol"]])
    kidx.field("kf").import_bits(np.array([1, 1, 2]), kcols)
    kidx.mark_exists(kcols)
    path = str(tmp_path_factory.mktemp("mesh") / "holder")
    jax_snapshot.save(holder, path)
    return holder, path


def _shards_for(n: int):
    return list(range(n + 3))


@pytest.fixture(scope="module", params=[1, 2, 8])
def engines(request, holders):
    n = request.param
    holder, path = holders
    return (n, JaxExecutor(holder, mesh=jax_make_mesh(n)),
            Executor(snapshot.load(path), mesh=cpu_mesh(n)))


@pytest.mark.parametrize("query", MIX)
def test_mesh_matches_jax_mesh(engines, query):
    n, jx, port = engines
    index, q = _split(query)
    shards = None if index == "dryk" else _shards_for(n)
    assert canon(port.execute(index, q, shards)[0]) == \
        canon(jx.execute(index, q, shards)[0]), query


@pytest.mark.parametrize("query", LEVELWISE)
def test_levelwise_groupby_matches_jax_mesh(engines, query):
    """Both GroupBy caps at 0: the mesh GroupBy's frontier expansion."""
    n, jx, port = engines
    for ex in (jx, port):
        ex.GROUPBY_ONESHOT_MAX_COUNTS = 0
        ex.GROUPBY_ONESHOT_MAX_MASK_BYTES = 0
    try:
        assert canon(port.execute("mix", query, _shards_for(n))[0]) == \
            canon(jx.execute("mix", query, _shards_for(n))[0]), query
    finally:
        for ex in (jx, port):
            del ex.GROUPBY_ONESHOT_MAX_COUNTS
            del ex.GROUPBY_ONESHOT_MAX_MASK_BYTES


def test_one_member_mesh_equals_no_mesh(holders):
    _, path = holders
    one = Executor(snapshot.load(path), mesh=cpu_mesh(1))
    plain = Executor(snapshot.load(path), device="cpu")
    for query in MIX:
        index, q = _split(query)
        assert canon(one.execute(index, q)[0]) == \
            canon(plain.execute(index, q)[0]), query


# one stacked route a family: the kernel wrapper it calls once a member
LAUNCHES = [
    ("Count(Intersect(Row(f=1), Row(n > 0)))", "plan_eval"),
    ("Sum(Row(f=1), field=n)", "bsi_sum_planes"),
    ("Min(field=n)", "bsi_min_max"),
    ("TopN(f, Row(g=2))", "row_counts"),
    ("Rows(f)", "row_counts"),
    ("Distinct(Row(f=3), field=g)", "row_counts"),
    ("GroupBy(Rows(f), Rows(g))", "pair_counts"),
    ("GroupBy(Rows(f), aggregate=Sum(field=n))", "bsi_sum_groups"),
    ("Distinct(field=n)", "bsi_decode"),
    ("Extract(All(), Rows(n))", "bsi_decode_gather_sharded"),
    ("Var(field=n)", "var_moments"),
    ("Corr(field=n, field2=n, filter=Row(g=1))", "corr_moments"),
]


@pytest.mark.parametrize("query,kernel", LAUNCHES)
def test_one_kernel_call_a_member(holders, monkeypatch, query, kernel):
    """Each family's stacked route on a 4-member mesh calls its kernel's
    wrapper once a member, on that member's block (11 shards: blocks of
    3, the last with one padding row), and answers as no mesh does."""
    _, path = holders
    mesh_ex = Executor(snapshot.load(path), mesh=cpu_mesh(4))
    want = Executor(snapshot.load(path), device="cpu").execute("mix", query)
    calls = []
    real = getattr(ck, kernel)

    def counted(*args, **kwargs):
        calls.append(args[0])
        return real(*args, **kwargs)
    monkeypatch.setattr(ck, kernel, counted)
    got = mesh_ex.execute("mix", query)
    assert canon(got[0]) == canon(want[0])
    if kernel == "bsi_decode_gather_sharded":
        assert [len(groups) for groups in calls] == [3, 3, 3, 2]
    else:
        assert len(calls) == 4, len(calls)


def test_percentile_rounds_a_member(holders, monkeypatch):
    """Every round of a mesh Percentile is one kernel-I' call a member."""
    _, path = holders
    mesh_ex = Executor(snapshot.load(path), mesh=cpu_mesh(4))
    (want,) = Executor(snapshot.load(path), device="cpu").execute(
        "mix", "Percentile(field=n, nth=37)")
    calls = []
    real = ck.percentile_counts

    def counted(*args, **kwargs):
        calls.append(len(args[4]))
        return real(*args, **kwargs)
    monkeypatch.setattr(ck, "percentile_counts", counted)
    (got,) = mesh_ex.execute("mix", "Percentile(field=n, nth=37)")
    assert (got.val, got.count) == (want.val, want.count)
    rounds = [calls[i:i + 4] for i in range(0, len(calls), 4)]
    assert len(rounds) >= 2 and all(len(set(r)) == 1 and len(r) == 4
                                    for r in rounds), calls


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip(n):
    assert "ok" in dryrun_multichip(n, ["cpu"] * n)


def test_make_mesh_rules():
    mesh = make_mesh(2, ["cpu"] * 3)
    assert mesh.size == 2 and mesh.local == [0, 1]
    with pytest.raises(ValueError):
        make_mesh(4, ["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh(devices=["cuda"])


# -- tests/test_plan_parallel.py's counterparts -----------------------------

PARITY_QUERIES = [
    "Row(f=1)",
    "Union(Row(f=1), Row(f=2))",
    "Intersect(Row(f=1), Row(n > -100))",
    "Difference(Row(f=1), Row(f=2))",
    "Xor(Row(f=1), Row(f=2))",
    "Not(Row(f=1))",
    "Row(n > 0)",
    "Row(n <= -50)",
    "Row(-100 <= n < 100)",
    "Row(n != null)",
    "Row(n == 0)",
    "Intersect(All(), Row(f=1))",
    "Shift(Row(f=1), n=3)",
]


def test_shard_device_deterministic():
    assert shard_device("i", 0, 8) == shard_device("i", 0, 8)
    byd = shards_by_device("i", list(range(100)), 8)
    assert sum(len(v) for v in byd.values()) == 100
    # reasonably balanced over 8 devices
    assert all(len(v) > 3 for v in byd.values())
    from featurebase_tpu.parallel.mesh import \
        shards_by_device as jax_shards_by_device
    assert byd == jax_shards_by_device("i", list(range(100)), 8)


def test_mesh_sharded_execution():
    """The engine over an 8-member CPU mesh: results equal the unsharded
    run's (tests/test_plan_parallel.py's fixture data, 5 shards)."""
    from featurebase_tpu_torch.model.field import FieldOptions
    from featurebase_tpu_torch.model.index import Holder
    holder = Holder()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("n", FieldOptions(type="int", min=-1000, max=1000))
    e = Executor(holder, device="cpu")
    rng = np.random.default_rng(3)
    for s in range(5):
        base = s * SW
        for c in rng.integers(0, 1000, size=30):
            e.execute("i", f"Set({base + int(c)}, f=1)")
        for c in rng.integers(1000, 2000, size=20):
            e.execute("i", f"Set({base + int(c)}, f=2)")
        for c in rng.integers(0, 500, size=15):
            e.execute("i", f"Set({base + int(c)}, n={int(c) - 250})")
    em = Executor(holder, mesh=cpu_mesh(8))
    for src in PARITY_QUERIES:
        got = em.execute("i", f"Count({src})")[0]
        want = e.execute("i", f"Count({src})")[0]
        assert got == want, src
        np.testing.assert_array_equal(em.execute("i", src)[0].columns(),
                                      e.execute("i", src)[0].columns())
    row_m = em.execute("i", "Intersect(Row(f=1), Row(n > -100))")[0]
    row_s = e.execute("i", "Intersect(Row(f=1), Row(n > -100))")[0]
    np.testing.assert_array_equal(row_m.columns(), row_s.columns())


def test_mesh_residency_blocks(holders):
    """Each member block registers its own bytes with the residency LRU,
    and evicting one drops the entry (rebuilt on next use)."""
    from featurebase_tpu_torch.storage.residency import residency
    _, path = holders
    ex = Executor(snapshot.load(path), mesh=cpu_mesh(4))
    (want,) = ex.execute("mix", "Sum(field=n)")
    pe = ex.plan_executor
    keys = [k for k in pe._leaf_cache if k[0] == "bsi"]
    assert len(keys) == 1
    rkeys = pe._rkeys(keys[0])
    assert [rk[-1] for rk in rkeys] == [0, 1, 2, 3]
    entries = residency()._entries
    assert all(rk in entries for rk in rkeys)
    block = pe._leaf_cache[keys[0]][1].blocks[0]
    assert entries[rkeys[0]][0] == block.numel() * 4
    entries[rkeys[1]][1]()    # the LRU evicts block 1
    assert keys[0] not in pe._leaf_cache
    assert not any(rk in residency()._entries for rk in rkeys)
    (again,) = ex.execute("mix", "Sum(field=n)")
    assert (again.val, again.count) == (want.val, want.count)
