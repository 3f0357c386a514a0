"""The plain versions of kernels C and D, and their host finishes, against
the JAX package's BSI aggregates.

Identical numpy groups (made from a seed) go through
featurebase_tpu/ops/bsi.py (sum_planes_stacked with agg.finalize_sum,
min_max_stacked, and min_host/max_host per shard merged with the JAX
ValCount.smaller/larger) and through the port's ops/bsi.py.  Answers are
integers, so the tolerance is zero.  Every plane count stays below 2^32,
where the JAX side counts in uint32.  The CUDA kernels are held against
these plain versions on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from featurebase_tpu.executor.results import ValCount as JaxValCount
from featurebase_tpu.ops import bsi as jbsi
from featurebase_tpu.parallel import agg as jagg
from featurebase_tpu_torch.ops import bsi
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.parallel.agg import finalize_sum

S, W = 3, 64          # 2048 columns a shard
C = 32 * W
DEPTHS = (1, 14, 31, 32)
KINDS = ("values", "sign_zero", "all_negative", "empty_filter",
         "ones_filter", "ties")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pack(bits: np.ndarray) -> np.ndarray:
    """(S, C) bool -> (S, W) uint32 words (column c at word c / 32, bit
    c % 32)."""
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)


def make_group(depth: int, kind: str, seed: int = 0):
    """An (S, depth + 2, W) uint32 group and an (S, W) uint32 filter, with
    their generating arrays."""
    rng = np.random.default_rng([depth, KINDS.index(kind), seed])
    top = 1 << min(depth, 3) if kind == "ties" else 1 << depth
    mag = rng.integers(0, top, size=(S, C), dtype=np.uint64)
    neg = rng.random((S, C)) < 0.5
    ex = rng.random((S, C)) < 0.6
    filt = rng.random((S, C)) < 0.7
    if kind == "sign_zero":         # a set sign on magnitude 0: "-0"
        mag[rng.random((S, C)) < 0.2] = 0
        neg[:, ::2] = True
    if kind == "all_negative":
        neg[:] = True
    if kind == "empty_filter":
        filt[:] = False
    if kind == "ones_filter":
        filt[:] = True
    if kind == "ties":              # every shard the same: ties across them
        mag[1:], neg[1:], ex[1:] = mag[0], neg[0], ex[0]
    planes = [ex, ex & neg] + [ex & (((mag >> np.uint64(d)) & np.uint64(1))
                                     == 1) for d in range(depth)]
    group = np.stack([pack(p) for p in planes], axis=1)
    return group, pack(filt), (mag, neg, ex & filt)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def jax_min_max_per_shard(group, filt, depth, is_min):
    """The JAX executor's per-shard path (executor.py:1221-1236)."""
    acc = JaxValCount()
    fn = jbsi.min_host if is_min else jbsi.max_host
    for s in range(group.shape[0]):
        v, c = fn(group[s, 2:], group[s, 0], group[s, 1], filt[s], depth)
        if c == 0:
            continue
        vc = JaxValCount(v, c)
        acc = acc.smaller(vc) if is_min else acc.larger(vc)
    return acc.val, acc.count


def port_min_max_per_shard(parts, is_min):
    from featurebase_tpu_torch.executor.results import ValCount
    acc = ValCount()
    for v, c in bsi.min_max_per_shard(parts, is_min):
        if c == 0:
            continue
        vc = ValCount(v, c)
        acc = acc.smaller(vc) if is_min else acc.larger(vc)
    return acc.val, acc.count


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth", DEPTHS)
def test_sum_matches_sum_planes_stacked(depth, kind):
    group, filt, (mag, neg, sel) = make_group(depth, kind)
    pp, nn, cnt = jbsi.sum_planes_stacked(group, filt)
    parts = bsi.sum_planes_plain(t(group), t(filt)).numpy()
    np.testing.assert_array_equal(parts[:depth], np.asarray(pp))
    np.testing.assert_array_equal(parts[depth:2 * depth], np.asarray(nn))
    assert parts[2 * depth] == int(cnt) == sel.sum()
    total = finalize_sum(parts[:depth], parts[depth:2 * depth])
    assert total == jagg.finalize_sum(pp, nn)
    signed = np.where(neg, -mag.astype(object), mag.astype(object))
    assert total == sum(signed[sel])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth", (1, 14, 31))
@pytest.mark.parametrize("is_min", (True, False))
def test_stacked_finish_matches_min_max_stacked(depth, kind, is_min):
    group, filt, _ = make_group(depth, kind)
    v, c = jbsi.min_max_stacked(group, filt, depth, is_min)
    want = (int(v), int(c)) if int(c) else (0, 0)
    parts = bsi.min_max_parts_plain(t(group), t(filt), is_min).numpy()
    assert bsi.min_max_stacked_finish(parts, is_min) == want


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("is_min", (True, False))
def test_per_shard_finish_matches_min_host_max_host(depth, kind, is_min):
    group, filt, _ = make_group(depth, kind)
    parts = bsi.min_max_parts_plain(t(group), t(filt), is_min).numpy()
    assert port_min_max_per_shard(parts, is_min) == \
        jax_min_max_per_shard(group, filt, depth, is_min)


@pytest.mark.parametrize("depth", DEPTHS)
def test_descents_match_minmax_parts_kernel(depth):
    """Each descent of every shard, bit for bit, against the reference's
    minmax_parts_kernel (bsi.py:200): a Min's pos-min and neg-max, a Max's
    pos-max and neg-min, and (0, 0) for the two a call does not run."""
    group, filt, _ = make_group(depth, "sign_zero")
    names = ("pos_min", "pos_max", "neg_min", "neg_max")
    for is_min, ran in ((True, (0, 3)), (False, (1, 2))):
        parts = bsi.min_max_parts_plain(t(group), t(filt), is_min).numpy()
        for s in range(S):
            p = jbsi.minmax_parts_kernel(group[s, 2:], group[s, 0],
                                         group[s, 1], filt[s], depth)
            for k, name in enumerate(names):
                bits, cnt = p[name]
                want = (jbsi._bits_to_int(bits), int(cnt)) if k in ran \
                    else (0, 0)
                assert (int(parts[s, k, 0]), int(parts[s, k, 1])) == want, \
                    (s, name)
            assert bool(p["has_pos"]) == (parts[s, ran[0], 1] > 0)
            assert bool(p["has_neg"]) == (parts[s, ran[1], 1] > 0)


def test_sign_set_zero_semantics_differ_by_depth():
    """One shard of positive zeros and sign-set zeros: the stacked
    semantics (depth <= 31) count them together, the per-shard ones
    (depth 32 and up) take the negatives alone — as the reference does on
    each side of the switch."""
    depth = 4
    ex = np.zeros((1, C), dtype=bool)
    ex[0, :10] = True
    neg = np.zeros((1, C), dtype=bool)
    neg[0, :3] = True                  # three -0, seven +0
    planes = [ex, ex & neg] + [np.zeros((1, C), dtype=bool)] * depth
    group = np.stack([pack(p) for p in planes], axis=1)
    filt = pack(np.ones((1, C), dtype=bool))
    parts = bsi.min_max_parts_plain(t(group), t(filt), True).numpy()
    stacked = jbsi.min_max_stacked(group, filt, depth, True)
    assert bsi.min_max_stacked_finish(parts, True) == \
        (int(stacked[0]), int(stacked[1])) == (0, 10)
    assert port_min_max_per_shard(parts, True) == \
        jax_min_max_per_shard(group, filt, depth, True) == (0, 3)
    parts = bsi.min_max_parts_plain(t(group), t(filt), False).numpy()
    assert port_min_max_per_shard(parts, False) == \
        jax_min_max_per_shard(group, filt, depth, False) == (0, 7)


@pytest.mark.parametrize("depth", (1, 32, bsi.MAX_DEPTH))
def test_wrappers_run_the_plain_versions_on_cpu(depth):
    group, filt, _ = make_group(min(depth, 32), "values")
    if depth > 32:   # the deepest group the port's Field allows
        rng = np.random.default_rng(5)
        group = rng.integers(0, 1 << 32, size=(S, depth + 2, W),
                             dtype=np.uint64).astype(np.uint32)
    g, f = t(group), t(filt)
    ck.reset_launches()
    assert torch.equal(ck.bsi_sum_planes(g, f), bsi.sum_planes_plain(g, f))
    for is_min in (True, False):
        assert torch.equal(ck.bsi_min_max(g, f, is_min),
                           bsi.min_max_parts_plain(g, f, is_min))
    assert ck.launches()["bsi_sum_planes"] == 0
    assert ck.launches()["bsi_min_max"] == 0


def test_wrappers_validate_inputs():
    g = torch.zeros((2, 5, 8), dtype=torch.int32)
    f = torch.zeros((2, 8), dtype=torch.int32)
    for bad_g, bad_f in ((g.to(torch.int64), f), (g, f[:1]),
                         (g[:, :2], f), (g, f.to(torch.int64)),
                         (torch.zeros((2, bsi.MAX_DEPTH + 3, 8),
                                      dtype=torch.int32), f)):
        with pytest.raises(ValueError):
            ck.bsi_sum_planes(bad_g, bad_f)
        with pytest.raises(ValueError):
            ck.bsi_min_max(bad_g, bad_f, True)
