"""GroupBy's device programs: the port against the JAX package.

Kernels E (``pair_counts``) and F (``bsi_sum_groups``) of
featurebase_tpu_torch/ops/cuda_kernels.py run their plain versions on CPU
tensors; they are held against the XLA programs they replace
(featurebase_tpu/ops/bitwise.py count_and_pairs, stacked_pair_counts;
ops/bsi.py sum_groups_kernel, sum_groups_stacked, sum_groups_host), with
the elementwise mask products and the row-count reductions of GroupBy and
Rows beside them.  Inputs are seeded numpy words; S in {1, 3}, ragged F,
R and G, BSI depths 1, 14, 31 and 32.  Every answer is exact (the JAX side
counts in uint32, and every count here stays far below 2^32)."""
import numpy as np
import pytest
import torch

from featurebase_tpu.ops import bitwise as jbw
from featurebase_tpu.ops import bsi as jbsi
from featurebase_tpu_torch.ops import bitwise as bw
from featurebase_tpu_torch.ops import bsi as bsiops
from featurebase_tpu_torch.ops import cuda_kernels as ck

W = 96   # words a row: small, and a multiple of neither 128 nor 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(rng, shape, density=None) -> np.ndarray:
    """uint32 words: uniform, or each bit set with `density`."""
    if density is None:
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
            .astype(np.uint32)
    bits = rng.random(tuple(shape) + (32,)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32) \
        .reshape(shape)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def n(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


SHAPES = [(1, 1, 1), (1, 4, 3), (1, 9, 5), (3, 2, 7), (3, 8, 4), (3, 11, 9)]


@pytest.mark.parametrize("S,F,R", SHAPES)
@pytest.mark.parametrize("filtered", [False, True])
def test_pair_counts_match_stacked_pair_counts(S, F, R, filtered):
    rng = np.random.default_rng(S * 100 + F * 10 + R)
    masks, rows = words(rng, (S, F, W)), words(rng, (S, R, W))
    filt = words(rng, (S, W)) if filtered else None
    jm = masks if filt is None else np.asarray(
        jbw.stacked_mask_filter(masks, filt))
    want = n(jbw.stacked_pair_counts(jm, rows))
    got = ck.pair_counts(t(masks), t(rows),
                         None if filt is None else t(filt))
    assert got.dtype == torch.int64 and got.shape == (F, R)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bw.stacked_pair_counts(t(masks), t(rows),
                               None if filt is None else t(filt)).numpy(),
        want)


@pytest.mark.parametrize("F,R", [(1, 1), (5, 3), (8, 4), (13, 10)])
def test_count_and_pairs_match_jax(F, R):
    rng = np.random.default_rng(F * 31 + R)
    masks, rows = words(rng, (F, W), 0.3), words(rng, (R, W), 0.6)
    np.testing.assert_array_equal(bw.count_and_pairs(t(masks), t(rows)),
                                  n(jbw.count_and_pairs(masks, rows)))


@pytest.mark.parametrize("density", [0.0, 1.0])
def test_pair_counts_empty_and_full_words(density):
    rng = np.random.default_rng(5)
    masks, rows = words(rng, (3, 4, W), density), words(rng, (3, 6, W))
    np.testing.assert_array_equal(
        ck.pair_counts(t(masks), t(rows)).numpy(),
        n(jbw.stacked_pair_counts(masks, rows)))


def test_pair_counts_rejects_mismatched_shapes():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="do not match"):
        ck.pair_counts(t(words(rng, (2, 3, W))), t(words(rng, (3, 3, W))))
    with pytest.raises(ValueError, match="filter"):
        ck.pair_counts(t(words(rng, (2, 3, W))), t(words(rng, (2, 3, W))),
                       t(words(rng, (2, W + 1))))


def bsi_group(rng, S: int, depth: int) -> np.ndarray:
    """(S, depth + 2, W) group of encoded values: exists on 70% of the
    columns, the sign on 40% of those and on some columns without a value,
    magnitudes below 2^depth with some sign-set zeros."""
    ex = words(rng, (S, W), 0.7)
    sign = words(rng, (S, W), 0.4) | (words(rng, (S, W), 0.1) & ~ex)
    planes = words(rng, (S, depth, W), 0.5)
    return np.concatenate([ex[:, None], sign[:, None], planes], axis=1)


GROUPS = [(1, 1, 1), (1, 14, 5), (1, 31, 8), (1, 32, 3), (3, 1, 7),
          (3, 14, 2), (3, 31, 9), (3, 32, 4)]


@pytest.mark.parametrize("S,depth,G", GROUPS)
def test_bsi_sum_groups_match_sum_groups_stacked(S, depth, G):
    rng = np.random.default_rng(S * 1000 + depth * 10 + G)
    group, masks = bsi_group(rng, S, depth), words(rng, (S, G, W), 0.5)
    pos, neg, cnt = (n(x) for x in jbsi.sum_groups_stacked(group, masks,
                                                           depth))
    got = ck.bsi_sum_groups(t(group), t(masks))
    assert got.dtype == torch.int64 and got.shape == (G, 2 * depth + 1)
    np.testing.assert_array_equal(got[:, :depth].numpy(), pos)
    np.testing.assert_array_equal(got[:, depth:2 * depth].numpy(), neg)
    np.testing.assert_array_equal(got[:, 2 * depth].numpy(), cnt)


@pytest.mark.parametrize("depth,G", [(1, 3), (14, 32), (31, 6), (32, 11)])
def test_bsi_sum_groups_at_one_shard_match_sum_groups_kernel(depth, G):
    rng = np.random.default_rng(depth * 7 + G)
    group, masks = bsi_group(rng, 1, depth)[0], words(rng, (G, W), 0.5)
    pos, neg, cnt = (n(x) for x in jbsi.sum_groups_kernel(
        group[2:], group[0], group[1], masks, depth))
    got = ck.bsi_sum_groups(t(group)[None], t(masks)[None]).numpy()
    np.testing.assert_array_equal(got[:, :depth], pos.T)
    np.testing.assert_array_equal(got[:, depth:2 * depth], neg.T)
    np.testing.assert_array_equal(got[:, 2 * depth], cnt)
    # the exact finish: each group's (sum, count) as sum_groups_host gives
    sums, counts = jbsi.sum_groups_host(group[2:], group[0], group[1], masks,
                                        depth)
    assert bsiops.finish_groups(got) == list(zip(sums, counts))


def test_bsi_sum_groups_one_mask_is_kernel_c():
    rng = np.random.default_rng(3)
    group, filt = bsi_group(rng, 3, 14), words(rng, (3, W))
    np.testing.assert_array_equal(
        ck.bsi_sum_groups(t(group), t(filt)[:, None])[0].numpy(),
        ck.bsi_sum_planes(t(group), t(filt)).numpy())


# -- the elementwise mask products and the row-count reductions -------------

@pytest.mark.parametrize("F,R", [(1, 1), (3, 5), (6, 2)])
def test_all_pairs_and_orders_r_fastest(F, R):
    rng = np.random.default_rng(F + 10 * R)
    masks, rows = words(rng, (F, W)), words(rng, (R, W))
    np.testing.assert_array_equal(
        bw.all_pairs_and(t(masks), t(rows)).numpy().view(np.uint32),
        np.asarray(jbw.all_pairs_and(masks, rows)))


@pytest.mark.parametrize("S,F,R", [(1, 2, 3), (3, 4, 2)])
def test_stacked_all_pairs_and_and_mask_filter_match_jax(S, F, R):
    rng = np.random.default_rng(S + F + R)
    masks, rows, filt = words(rng, (S, F, W)), words(rng, (S, R, W)), \
        words(rng, (S, W))
    np.testing.assert_array_equal(
        bw.stacked_all_pairs_and(t(masks), t(rows)).numpy().view(np.uint32),
        np.asarray(jbw.stacked_all_pairs_and(masks, rows)))
    np.testing.assert_array_equal(
        bw.stacked_mask_filter(t(masks), t(filt)).numpy().view(np.uint32),
        np.asarray(jbw.stacked_mask_filter(masks, filt)))


def test_and_pairs_gather_matches_jax():
    rng = np.random.default_rng(11)
    masks, rows = words(rng, (5, W)), words(rng, (4, W))
    fi, rj = np.array([0, 0, 3, 4], np.int32), np.array([1, 3, 0, 3],
                                                         np.int32)
    got = bw.and_pairs_gather(t(masks), t(rows), torch.from_numpy(fi).long(),
                              torch.from_numpy(rj).long())
    np.testing.assert_array_equal(
        got.numpy().view(np.uint32),
        np.asarray(jbw.and_pairs_gather(masks, rows, fi, rj)))


@pytest.mark.parametrize("R", [0, 1, 2, 5, 8, 13])
def test_or_reduce_rows_matches_jax(R):
    rng = np.random.default_rng(R)
    tile = words(rng, (R, W), 0.05)
    got = bw.or_reduce_rows(t(tile).reshape(R, W)).numpy().view(np.uint32)
    want = np.asarray(jbw.or_reduce_rows(tile)) if R else \
        np.zeros(W, np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.0, 0.001])
def test_any_set_matches_jax(density):
    x = words(np.random.default_rng(2), (3, W), density)
    assert bw.any_set(t(x)) == bool(jbw.any_set(x))


@pytest.mark.parametrize("S,R", [(1, 1), (3, 6)])
def test_stacked_row_counts_match_jax(S, R):
    rng = np.random.default_rng(S * 9 + R)
    tiles, filt = words(rng, (S, R, W)), words(rng, (S, W))
    np.testing.assert_array_equal(bw.stacked_row_counts(t(tiles)).numpy(),
                                  n(jbw.stacked_row_counts(tiles)))
    np.testing.assert_array_equal(
        bw.stacked_filtered_row_counts(t(tiles), t(filt)).numpy(),
        n(jbw.stacked_filtered_row_counts(tiles, filt)))


def test_cpu_tensors_launch_no_group_kernel():
    rng = np.random.default_rng(1)
    ck.reset_launches()
    ck.pair_counts(t(words(rng, (2, 3, W))), t(words(rng, (2, 4, W))))
    ck.bsi_sum_groups(t(bsi_group(rng, 2, 5)), t(words(rng, (2, 3, W))))
    assert ck.launches()["pair_counts"] == 0
    assert ck.launches()["bsi_sum_groups"] == 0
