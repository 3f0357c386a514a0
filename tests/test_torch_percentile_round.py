"""Kernel I' (percentile_counts): its plain version against a numpy
histogram at the round widths the kernel's forms take, and the bisection it
drives against the JAX package's percentile_fused.

The kernel has three forms by K, the count of thresholds: the prep pass
(K = 0), a round that merges a warp's equal bins (K <= 8: the K = 2 rounds
of nth 0 and 100 send almost every value to one bin) and a wide round (a
bisection round is 129 thresholds, the kernel takes up to 512).  Each width
here: random thresholds, duplicated ones, every value below them, every
value above them, every value equal to one of them, and a base that wraps
value + base in int32.  The histogram (bin 2k: t[k-1] < x < t[k]; bin 2k +
1: x == t[k], empty for a repeat) then the min and the max must equal
numpy's, exactly; so must percentile's answers equal percentile_fused's on
values that crowd into the bins these rounds make."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurebase_tpu.ops import bsi as jbsi
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import decode

W = 64   # words a shard row (2,048 columns)
S = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def numpy_counts(vals, exists, filt, base, thresholds) -> list:
    present = decode.expand_bits_host((exists & filt).reshape(-1))
    x = vals.reshape(-1)[present].astype(np.int64) + base
    x = (x + (1 << 31)) % (1 << 32) - (1 << 31)   # int32 wrap
    t = np.asarray(thresholds, dtype=np.int64)
    k = np.searchsorted(t, x, side="left")
    eq = (k < t.size) & (t[np.minimum(k, max(t.size - 1, 0))] == x) \
        if t.size else np.zeros(x.size, dtype=bool)
    hist = np.bincount(2 * k + eq, minlength=2 * t.size + 1)
    lo = int(x.min()) if x.size else (1 << 31) - 1
    hi = int(x.max()) if x.size else -(1 << 31)
    return hist.tolist() + [lo, hi]


def thresholds_for(kind: str, K: int, rng, lo: int, hi: int) -> list:
    if kind == "random":
        return sorted(rng.integers(lo, hi + 1, K).tolist())
    if kind == "duplicates":
        picks = rng.integers(lo, hi + 1, max(K // 3, 1))
        return sorted(rng.choice(picks, K).tolist())
    if kind == "all_below":    # every value below the thresholds
        return sorted(rng.integers(hi + 1, hi + 1000, K).tolist())
    if kind == "all_above":    # every value above them
        return sorted(rng.integers(lo - 1000, lo, K).tolist())
    assert kind == "equal"     # thresholds at values: many x == t[k]
    return sorted(rng.choice(np.arange(lo, hi + 1), K).tolist())


@pytest.mark.parametrize("K", [0, 1, 2, 129, 512])
@pytest.mark.parametrize("kind", ["random", "duplicates", "all_below",
                                  "all_above", "equal"])
def test_percentile_counts_plain_against_numpy(K, kind):
    rng = np.random.default_rng(K * 13 + len(kind))
    lo, hi = -300, 300
    vals = rng.integers(lo, hi + 1, (S, 32 * W)).astype(np.int32)
    exists, filt = words(rng, (S, W)), words(rng, (S, W))
    t = thresholds_for(kind, K, rng, lo, hi) if K else []
    got = ck.percentile_counts(t32(vals), t32(exists), t32(filt), 0, t)
    assert got.tolist() == numpy_counts(vals, exists, filt, 0, t)
    if K and kind == "all_below":
        assert got[0] == got[:2 * K + 1].sum()
    if K and kind == "all_above":
        assert got[2 * K] == got[:2 * K + 1].sum()


@pytest.mark.parametrize("K", [1, 2, 129, 512])
def test_percentile_counts_plain_wraps_value_plus_base(K):
    """value + base wraps in int32, as the kernel adds them."""
    rng = np.random.default_rng(K)
    vals = rng.integers(-(1 << 31), 1 << 31, (S, 32 * W)).astype(np.int32)
    exists, filt = words(rng, (S, W)), words(rng, (S, W))
    base = (1 << 31) - 5
    t = sorted(rng.integers(-(1 << 31), 1 << 31, K).tolist())
    got = ck.percentile_counts(t32(vals), t32(exists), t32(filt), base, t)
    assert got.tolist() == numpy_counts(vals, exists, filt, base, t)


def test_prep_pass_of_no_present_column():
    z = np.zeros((S, W), dtype=np.uint32)
    vals = np.ones((S, 32 * W), dtype=np.int32)
    got = ck.percentile_counts(t32(vals), t32(z), t32(z), 0, [])
    assert got.tolist() == [0, (1 << 31) - 1, -(1 << 31)]


def jax_percentile(vals, exists, filt, base, nth):
    val, cnt = jbsi.percentile_fused(
        jnp.asarray(vals), jnp.asarray(exists), jnp.asarray(filt), int(base),
        *jbsi.nth_limbs(nth))
    return (int(val), int(cnt)) if int(cnt) else (0, 0)


# values crowding into a few bins: one value nearly everywhere with a few
# outliers (the K = 2 rounds of nth 0 and 100 see almost all of them in one
# bin), two values, and a spread with a heavy tie
CROWDS = {
    "one_value": lambda rng, n: np.where(rng.random(n) < 0.995, 7,
                                         rng.integers(-50, 50, n)),
    "two_values": lambda rng, n: rng.choice([-3, 11], n),
    "heavy_tie": lambda rng, n: np.where(rng.random(n) < 0.6, 1000,
                                         rng.integers(-5000, 5000, n)),
}


@pytest.mark.parametrize("crowd", sorted(CROWDS))
@pytest.mark.parametrize("nth", [0, 0.1, 50, 99.9, 100])
def test_percentile_matches_percentile_fused_on_crowded_values(crowd, nth):
    rng = np.random.default_rng(len(crowd) + int(nth * 10))
    vals = CROWDS[crowd](rng, S * 32 * W).astype(np.int32).reshape(S, -1)
    exists, filt = words(rng, (S, W)), words(rng, (S, W))
    want = jax_percentile(vals, exists, filt, 0, nth)
    got = decode.percentile(t32(vals), t32(exists), t32(filt), 0, nth)
    assert got == want
