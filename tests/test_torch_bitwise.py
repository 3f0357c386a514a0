"""Parity of featurebase_tpu_torch.ops.bitwise with featurebase_tpu.ops.bitwise.

Same numpy-seeded uint32 words go through the JAX op and the port's torch
op on the CPU (the port's plain kernel versions); tolerance is exact: equal
words and equal counts (every total stays below 2^32, the JAX side's count
width)."""
import numpy as np
import pytest
import torch

from featurebase_tpu.ops import bitwise as jbw
from featurebase_tpu_torch.ops import bitwise as tbw

W = 32768


def words(rng, shape, density=0.5):
    """uint32 words with about `density` of the bits set."""
    bits = rng.random(shape + (32,)) < density
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32) \
        .reshape(shape)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def host(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return {"a": words(rng, (3, W)), "b": words(rng, (3, W), 0.2),
            "tile": words(rng, (2, 5, W), 0.3),
            "filt": words(rng, (2, W), 0.6)}


@pytest.mark.parametrize("name", ["b_and", "b_or", "b_xor", "b_andnot"])
def test_binary_ops(data, name):
    a, b = data["a"], data["b"]
    want = np.asarray(getattr(jbw, name)(a, b))
    got = host(getattr(tbw, name)(t(a), t(b)))
    np.testing.assert_array_equal(got, want)


def test_b_not(data):
    np.testing.assert_array_equal(host(tbw.b_not(t(data["a"]))),
                                  np.asarray(jbw.b_not(data["a"])))


def test_popcount(data):
    assert int(tbw.popcount(t(data["a"]))) == int(jbw.popcount(data["a"]))


def test_popcount_rows(data):
    np.testing.assert_array_equal(
        tbw.popcount_rows(t(data["tile"])).numpy(),
        np.asarray(jbw.popcount_rows(data["tile"])).astype(np.int64))


@pytest.mark.parametrize("with_acc", [False, True])
def test_count_and(data, with_acc):
    a, b = data["a"], data["b"]
    got = tbw.count_and(t(a), t(b),
                        torch.tensor([[7]], dtype=torch.int32)
                        if with_acc else None)
    assert int(got) == int(jbw.count_and(a, b)) + (7 if with_acc else 0)


def test_count_and_rows(data):
    tile, filt = data["tile"][0], data["filt"][:1]
    np.testing.assert_array_equal(
        tbw.count_and_rows(t(tile), t(filt)).numpy(),
        np.asarray(jbw.count_and_rows(tile, filt)).astype(np.int64))


def test_per_shard_row_counts(data):
    np.testing.assert_array_equal(
        tbw.per_shard_row_counts(t(data["tile"])).numpy(),
        np.asarray(jbw.per_shard_row_counts(data["tile"])).astype(np.int64))


@pytest.mark.parametrize("filt_density", [0.0, 0.6, 1.0])
def test_per_shard_filtered_row_counts(filt_density):
    rng = np.random.default_rng(int(filt_density * 10))
    tile, filt = words(rng, (2, 5, W), 0.3), words(rng, (2, W), filt_density)
    np.testing.assert_array_equal(
        tbw.per_shard_filtered_row_counts(t(tile), t(filt)).numpy(),
        np.asarray(jbw.per_shard_filtered_row_counts(tile, filt))
        .astype(np.int64))


@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 33, 100, 1000])
def test_b_shift(data, n):
    a = data["a"]
    got = host(tbw.b_shift(t(a), n))
    np.testing.assert_array_equal(got, np.asarray(jbw.b_shift(a, n)))
    # the input is untouched
    np.testing.assert_array_equal(host(t(a)), a)


@pytest.mark.parametrize("start,stop", [(0, 0), (3, 4), (5, 37), (31, 64),
                                        (100, 1 << 20), (0, 1 << 20)])
def test_range_mask(start, stop):
    np.testing.assert_array_equal(tbw.range_mask(start, stop),
                                  jbw.range_mask(start, stop))


def test_words_cols_round_trip(data):
    w = data["b"][0]
    cols = tbw.words_to_cols(w, base=3 << 20)
    np.testing.assert_array_equal(cols, jbw.words_to_cols(w, base=3 << 20))
    np.testing.assert_array_equal(tbw.cols_to_words(cols - (3 << 20)), w)
    np.testing.assert_array_equal(tbw.cols_to_words(cols - (3 << 20)),
                                  jbw.cols_to_words(cols - (3 << 20)))
    assert tbw.words_to_cols(np.zeros(8, np.uint32)).size == 0
