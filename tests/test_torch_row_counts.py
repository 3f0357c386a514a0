"""Kernel B' over address tables: row_counts_sharded_plain against the
Pallas kernels.

row_counts_sharded (ops/cuda_kernels.py) names each shard's rows by their
slots in a per-shard tile (a fragment's device mirror; -1 for a row the
shard lacks, None for a shard without a tile) and takes no filter, (S, W)
filter words, or a filter row a shard (None: a shard without one, whose
counts are 0).  Its plain version, which the wrapper runs on CPU tensors,
must equal featurebase_tpu/ops/pallas_kernels.py count_and_rows_pallas and
popcount_rows_pallas, run in interpret mode as the JAX package's own tests
run them, shard by shard over the same rows (zeros where absent).  The
stacked front, row_counts, must be the same function over the table of its
rows.  Tolerance is exact (integer counts)."""
import numpy as np
import pytest
import torch

from featurebase_tpu.ops import pallas_kernels as pk
from featurebase_tpu_torch.ops import cuda_kernels as ck

W = 1024
S = 5


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


def sharded(rng, R: int, absent: bool):
    """Per-shard tiles of a few more rows than R in shuffled slots and the
    (S, R) slot table; with `absent`, shard 1 has no tile and about one row
    in four is missing.  Also the (S, R, W) words those slots name."""
    tiles, slots = [], np.full((S, R), -1, dtype=np.int64)
    rows = np.zeros((S, R, W), dtype=np.uint32)
    for s in range(S):
        if absent and s == 1:
            tiles.append(None)
            continue
        n = R + 1 + s
        host = words(rng, (n, W))
        tiles.append(t(host))
        slots[s] = rng.permutation(n)[:R]
        if absent:
            slots[s, rng.random(R) < 0.25] = -1
        for i, sl in enumerate(slots[s]):
            if sl >= 0:
                rows[s, i] = host[sl]
    return tiles, slots, rows


def filters(rng, kind: str):
    """(the filter as row_counts_sharded takes it, its (S, W) words or
    None); per-shard rows leave shard 3 without one."""
    if kind == "none":
        return None, None
    f = words(rng, (S, W))
    if kind == "words":
        return t(f), f
    f[3] = 0
    return [t(f[s]) if s != 3 else None for s in range(S)], f


def pallas_counts(rows: np.ndarray, f) -> np.ndarray:
    return np.stack([
        np.asarray(pk.popcount_rows_pallas(rows[s]) if f is None
                   else pk.count_and_rows_pallas(rows[s], f[s]))
        for s in range(S)]).astype(np.int64)


@pytest.mark.parametrize("R", [1, 8, 13])
@pytest.mark.parametrize("absent", [False, True])
@pytest.mark.parametrize("kind", ["none", "words", "rows"])
def test_row_counts_sharded_plain_matches_pallas(R, absent, kind):
    rng = np.random.default_rng(R * 7 + absent * 3 + len(kind))
    tiles, slots, rows = sharded(rng, R, absent)
    filt, fw = filters(rng, kind)
    got = ck.row_counts_sharded_plain(tiles, slots, filt)
    np.testing.assert_array_equal(got.numpy(), pallas_counts(rows, fw))
    # the wrapper takes its plain version on CPU tensors
    np.testing.assert_array_equal(
        ck.row_counts_sharded(tiles, slots, filt).numpy(), got.numpy())


@pytest.mark.parametrize("kind", ["none", "words"])
def test_stacked_front_is_the_same_function(kind):
    """row_counts over an (S, R, W) tile equals row_counts_sharded over
    the tile's shards with every slot present."""
    rng = np.random.default_rng(11)
    tile = words(rng, (S, 8, W))
    filt, fw = filters(rng, kind)
    slots = np.tile(np.arange(8), (S, 1))
    got = ck.row_counts(t(tile), filt)
    np.testing.assert_array_equal(
        got.numpy(),
        ck.row_counts_sharded([t(x) for x in tile], slots, filt).numpy())
    np.testing.assert_array_equal(got.numpy(), pallas_counts(tile, fw))


def test_no_tile_anywhere_counts_zero():
    slots = np.full((3, 4), -1, dtype=np.int64)
    got = ck.row_counts_sharded([None] * 3, slots)
    assert got.shape == (3, 4) and not got.any()


def test_slot_table_shape_is_checked():
    tiles = [torch.zeros((2, W), dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="slots"):
        ck.row_counts_sharded(tiles, np.zeros((3, 1), dtype=np.int64))


def test_row_table_of_mirrors():
    """The table B' reads: tile s's row at slots[s, i], 0 for a missing row
    or a shard without a tile; filter rows after the rows, 0 for None."""
    a = torch.zeros((4, 8), dtype=torch.int32)
    b = torch.zeros((2, 8), dtype=torch.int32)
    slots = np.array([[3, -1], [0, 0], [1, 0]])
    got = ck._dim_addrs([a, None, b], slots, 8, "rows")
    assert got.tolist() == [[a.data_ptr() + 96, 0], [0, 0],
                            [b.data_ptr() + 32, b.data_ptr()]]
    f = torch.zeros(8, dtype=torch.int32)
    assert ck._filter_addrs([f, None, f], 3, 8)[:, 0].tolist() == \
        [f.data_ptr(), 0, f.data_ptr()]
