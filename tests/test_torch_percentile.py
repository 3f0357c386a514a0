"""Percentile: kernel I's plain version and the bisection of ops/decode.py
against the JAX package, then both executors.

Module parity: seeded values, exists and filter words go through
featurebase_tpu/ops/bsi.py percentile_fused (one program: prep, the
threshold cases and the bisection) and through the port's
decode.percentile, which drives kernel I's counts (its plain version here)
round by round; the answers (value, count) must be equal for many nth, with
ties, wide values, bases, an empty filter and total = 500.  Kernel I's
plain version is held against a numpy histogram.  The thresholds are exact
rationals of float(nth) in both packages, not Go's float64: at total = 500
and nth = 20.2, floor(total * nth / 100) is 100, where float64 gives 101.
Executor parity: a seeded Holder built with the JAX package and loaded into
the port; the fast path (int and decimal fields up to depth 31 under a
plannable filter) and the host bisection over Counts (a filter the plan
compiler refuses, a depth-43 field, a timestamp field whose values do not
fit int32 with its base)."""
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
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import decode
from featurebase_tpu_torch.storage import snapshot

W = 64   # words a shard row in the module cases (2,048 columns)
NTHS = [0, 0.5, 1, 10, 20.2, 25, 33.3, 50, 66.7, 75, 90, 99, 99.9, 100]


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


def jax_percentile(vals, exists, filt, base, nth):
    val, cnt = jbsi.percentile_fused(
        jnp.asarray(vals), jnp.asarray(exists), jnp.asarray(filt), int(base),
        *jbsi.nth_limbs(nth))
    return (int(val), int(cnt)) if int(cnt) else (0, 0)


def port_percentile(vals, exists, filt, base, nth):
    return decode.percentile(t32(vals), t32(exists), t32(filt), base, nth)


def columns_words(cols: np.ndarray, S: int) -> np.ndarray:
    """(S, W) words with the given flat columns of S x 32 W set."""
    w = np.zeros(S * W, dtype=np.uint32)
    np.bitwise_or.at(w, cols >> 5, np.uint32(1) << (cols & 31).astype(
        np.uint32))
    return w.reshape(S, W)


CASES = {
    # name: (S, value range, base, filter kind)
    "ties": (2, (-5, 5), 0, "random"),
    "wide": (3, (-(1 << 30), 1 << 30), 0, "ones"),
    "based": (2, (0, 3000), 1000, "random"),
    "negative_base": (2, (-2000, 0), -500, "ones"),
    "one_value": (1, (7, 8), 0, "ones"),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("nth", NTHS)
def test_percentile_matches_percentile_fused(case, nth):
    S, (lo, hi), base, fkind = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    vals = rng.integers(lo, hi, (S, 32 * W)).astype(np.int32)
    exists = words(rng, (S, W))
    filt = words(rng, (S, W)) if fkind == "random" else \
        np.full((S, W), 0xFFFFFFFF, dtype=np.uint32)
    assert port_percentile(vals, exists, filt, base, nth) == \
        jax_percentile(vals, exists, filt, base, nth)


@pytest.mark.parametrize("nth", [20.2, 0, 100, 0.7, 50])
def test_total_500(nth):
    """500 present columns of distinct values 0..499."""
    rng = np.random.default_rng(500)
    S = 2
    cols = rng.choice(S * 32 * W, 500, replace=False)
    vals = np.zeros(S * 32 * W, dtype=np.int32)
    vals[cols] = rng.permutation(500)
    vals = vals.reshape(S, 32 * W)
    exists = columns_words(cols, S)
    ones = np.full((S, W), 0xFFFFFFFF, dtype=np.uint32)
    got = port_percentile(vals, exists, ones, 0, nth)
    assert got == jax_percentile(vals, exists, ones, 0, nth)
    if nth == 0:
        assert got == (0, 1)
    if nth == 100:
        assert got == (499, 1)


def test_thresholds_are_exact_rationals_not_float64():
    num, den = decode.nth_ratio(20.2)
    assert 500 * num // den == 100 and int(500.0 * 20.2 / 100) == 101
    num, den = decode.nth_ratio(0.7)
    assert 1000 * num // den == 6 and int(1000.0 * 0.7 / 100) == 7


def test_empty_filter_gives_no_answer():
    rng = np.random.default_rng(1)
    vals = rng.integers(-9, 9, (2, 32 * W)).astype(np.int32)
    exists = words(rng, (2, W))
    zero = np.zeros((2, W), dtype=np.uint32)
    assert port_percentile(vals, exists, zero, 0, 50) == (0, 0) == \
        jax_percentile(vals, exists, zero, 0, 50)


def test_probe_sequence_is_the_references():
    """The pivots are Go's truncating arithmetic, and a round of kernel I
    counts every pivot the next levels can visit."""
    assert decode.pivot(-7, 4) == -1 and decode.pivot(-7, -4) == -5
    assert decode.pivot(3, 10) == 6 and decode.pivot(-1, 0) == 0
    tree = decode.pivot_tree(0, 100, 3)
    assert tree[0] == decode.pivot(0, 100) and len(tree) == 7


@pytest.mark.parametrize("thresholds", [
    [], [0], [-3, -3, 0, 4, 4, 4, 9], list(range(-10, 11, 3)), [100, 200]])
@pytest.mark.parametrize("base", [0, 5])
def test_percentile_counts_plain_against_numpy(thresholds, base):
    rng = np.random.default_rng(len(thresholds) + base)
    S = 2
    vals = rng.integers(-12, 12, (S, 32 * W)).astype(np.int32)
    exists, filt = words(rng, (S, W)), words(rng, (S, W))
    got = ck.percentile_counts(t32(vals), t32(exists), t32(filt), base,
                               thresholds).tolist()
    present = decode.expand_bits_host((exists & filt).reshape(-1))
    x = vals.reshape(-1)[present].astype(np.int64) + base
    t = np.asarray(thresholds, dtype=np.int64)
    k = np.searchsorted(t, x, side="left")
    eq = (k < t.size) & (t[np.minimum(k, max(t.size - 1, 0))] == x) \
        if t.size else np.zeros(x.size, dtype=bool)
    hist = np.bincount(2 * k + eq, minlength=2 * t.size + 1)
    assert got == hist.tolist() + [int(x.min()), int(x.max())]
    for i, tk in enumerate(thresholds):   # a repeat's bins stay empty
        if i and tk == thresholds[i - 1]:
            assert got[2 * i] == got[2 * i + 1] == 0


def test_percentile_counts_rejects_unsorted_thresholds():
    z = torch.zeros((1, W), dtype=torch.int32)
    with pytest.raises(ValueError, match="sorted"):
        ck.percentile_counts(torch.zeros((1, 32 * W), dtype=torch.int32), z,
                             z, 0, [3, 1])


# ---------------------------------------------------------------------------
# Executor parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(41)
    n = 2500
    cols = np.sort(rng.choice(3 * SW, n, replace=False))
    holder = JaxHolder()
    idx = holder.create_index("p")
    idx.create_field("f")
    idx.field("f").import_bits(rng.integers(0, 4, n), cols)
    idx.create_field("v", JaxFieldOptions(type="int", min=-400, max=1600))
    has_v = rng.random(n) < 0.9
    idx.field("v").import_values(cols[has_v],
                                 rng.integers(-400, 1600, int(has_v.sum())))
    idx.create_field("b", JaxFieldOptions(type="int", min=1000, max=5000))
    idx.field("b").import_values(cols, rng.integers(1000, 5000, n))
    idx.create_field("d", JaxFieldOptions(type="decimal", scale=2,
                                          min=-100, max=100))
    idx.field("d").import_values(cols, np.round(rng.uniform(-100, 100, n), 2))
    top = (1 << 43) - 1
    idx.create_field("w", JaxFieldOptions(type="int", min=-top, max=top))
    idx.field("w").import_values(cols, rng.integers(-50, 50, n) * (1 << 36))
    idx.create_field("ts", JaxFieldOptions(type="timestamp"))
    idx.field("ts").import_values(
        cols, 1_600_000_000 + rng.integers(0, 10_000, n))
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("pct") / "holder")
    jax_snapshot.save(holder, path)
    return JaxExecutor(holder), Executor(snapshot.load(path), device="cpu")


def norm(r):
    return None if r is None else (r.val, r.count, r.float_val,
                                   r.timestamp_val)


EXEC_QUERIES = [
    f"Percentile(field={fld}, nth={nth}{filt})"
    for fld in ("v", "b", "d")
    for nth in (0, 20.2, 50, 99.9, 100)
    for filt in ("", ", filter=Row(f=1)")
] + [
    "Percentile(field=v, nth=50, filter=Row(f=99))",
    "Percentile(field=v, nth=50, filter=Row(v > 1000))",
    "Percentile(field=v, nth=37.5, filter=Union(Row(f=null), Row(f=2)))",
    "Percentile(field=d, nth=75, filter=Union(Row(f=null), Row(f=2)))",
    "Percentile(field=w, nth=50)",
    "Percentile(field=w, nth=10, filter=Row(f=3))",
    "Percentile(field=ts, nth=50)",
    "Options(Percentile(field=v, nth=60), shards=[0, 2])",
]


@pytest.mark.parametrize("query", EXEC_QUERIES)
def test_executor_percentile_matches_jax(engines, query):
    jax_e, port_e = engines
    assert norm(port_e.execute("p", query)[0]) == \
        norm(jax_e.execute("p", query)[0])


def test_fast_path_runs_kernel_i_and_host_path_does_not(engines,
                                                        monkeypatch):
    _, port_e = engines
    counts = {}
    real = ck.percentile_counts

    def spy(*a):
        counts["n"] = counts.get("n", 0) + 1
        return real(*a)
    monkeypatch.setattr(ck, "percentile_counts", spy)
    port_e.execute("p", "Percentile(field=v, nth=50)")
    fast = counts.pop("n", 0)
    port_e.execute("p", "Percentile(field=w, nth=50)")
    host = counts.pop("n", 0)
    assert fast >= 2 and host == 0


@pytest.mark.parametrize("bad", ["nth=101", "nth=-1", ""])
def test_nth_is_validated(engines, bad):
    from featurebase_tpu_torch.executor.executor import ExecError
    _, port_e = engines
    sep = ", " if bad else ""
    with pytest.raises(ExecError, match="nth"):
        port_e.execute("p", f"Percentile(field=v{sep}{bad})")


def test_reference_bsi_cases(tmp_path):
    """tests/test_executor.py's TestBSI cases (Distinct, FieldValue,
    Percentile, Sort) on its five values, written with the JAX executor's
    PQL, through both executors, with the answers that file asserts: the
    median probe ends at 4, a value no column holds."""
    holder = JaxHolder()
    idx = holder.create_index("i")
    idx.create_field("n", JaxFieldOptions(type="int", min=-1000, max=1000))
    jax_e = JaxExecutor(holder)
    vals = {1: 5, 2: -10, 3: 100, 4: 0, SW + 1: 37}
    jax_e.execute("i", " ".join(f"Set({c}, n={v})" for c, v in vals.items()))
    path = str(tmp_path / "holder")
    jax_snapshot.save(holder, path)
    port_e = Executor(snapshot.load(path), device="cpu")

    def both(q):
        got, want = port_e.execute("i", q)[0], jax_e.execute("i", q)[0]
        return got, want
    got, want = both("Distinct(field=n)")
    assert got.values().tolist() == want.values().tolist() == \
        sorted(vals.values())
    assert both("Count(Distinct(field=n))") == (5, 5)
    got, want = both("FieldValue(field=n, column=3)")
    assert (got.val, got.count) == (want.val, want.count) == (100, 1)
    got, want = both("Percentile(field=n, nth=50)")
    assert got.val == want.val == 4
    got, want = both("Sort(All(), field=n)")
    assert got == want and got["columns"] == [2, 4, 1, SW + 1, 3]
    got, want = both("Sort(All(), field=n, sort-desc=true, limit=2)")
    assert got == want and got["columns"] == [3, SW + 1]
