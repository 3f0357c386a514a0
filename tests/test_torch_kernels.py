"""The plain versions of the port's CUDA kernels against the Pallas kernels.

featurebase_tpu/ops/pallas_kernels.py runs in interpret mode on the CPU, as
the JAX package's own tests run it; the port's wrappers run their plain
PyTorch versions on CPU tensors.  Tolerance is exact (integer counts, totals
below 2^32).  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

from featurebase_tpu.ops import pallas_kernels as pk
from featurebase_tpu_torch.ops import bitwise as tbw
from featurebase_tpu_torch.ops import cuda_kernels as ck

W = 1024


def words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("shape", [(16, W), (3, 1000), (2, 8, W)])
def test_plan_eval_and_matches_count_and_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    a, b = words(rng, shape), words(rng, shape)
    pb = ck.ProgramBuilder(1, a.size)
    r = pb.op(ck.OP_AND, pb.load(pb.plane(0, t(a).reshape(1, -1))),
              pb.load(pb.plane(1, t(b).reshape(1, -1))))
    words_out, counts = ck.plan_eval_plain(pb.build(r), True, True)
    assert int(counts[0]) == int(pk.count_and_pallas(a, b))
    np.testing.assert_array_equal(words_out.numpy().view(np.uint32),
                                  (a & b).reshape(1, -1))


def test_count_and_acc_matches_pallas():
    rng = np.random.default_rng(3)
    a, b = words(rng, (8, W)), words(rng, (8, W))
    acc = np.array([[41]], dtype=np.int32)
    want = int(pk.count_and_pallas(a, b, acc))
    assert int(tbw.count_and(t(a), t(b), torch.from_numpy(acc))) == want


@pytest.mark.parametrize("rows", [1, 8, 13])
def test_row_counts_filtered_matches_count_and_rows_pallas(rows):
    rng = np.random.default_rng(rows)
    tile, filt = words(rng, (rows, W)), words(rng, (W,))
    got = ck.row_counts(t(tile)[None], t(filt)[None])[0]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pk.count_and_rows_pallas(tile, filt)))


@pytest.mark.parametrize("rows", [1, 8, 13])
def test_row_counts_unfiltered_matches_popcount_rows_pallas(rows):
    rng = np.random.default_rng(100 + rows)
    tile = words(rng, (rows, W))
    got = ck.row_counts(t(tile)[None])[0]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(pk.popcount_rows_pallas(tile)))


def test_popcount_words_matches_numpy():
    rng = np.random.default_rng(5)
    x = np.concatenate([words(rng, (4096,)),
                        np.array([0, 1, 0x80000000, 0xFFFFFFFF,
                                  0x7FFFFFFF], dtype=np.uint32)])
    np.testing.assert_array_equal(ck.popcount_words(t(x)).numpy(),
                                  np.bitwise_count(x).astype(np.int64))


def test_popcount_swar_matches_numpy():
    """The SWAR that popcount_words takes on the card, held on a CPU tensor
    (popcount_words itself takes numpy's bitwise_count there)."""
    rng = np.random.default_rng(6)
    x = np.concatenate([words(rng, (4096,)),
                        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF,
                                  0x55555555, 0xAAAAAAAA], dtype=np.uint32)])
    np.testing.assert_array_equal(ck.popcount_swar(t(x)).numpy(),
                                  np.bitwise_count(x).astype(np.int64))


@pytest.mark.parametrize("op,want", [
    (ck.OP_ZERO, lambda a, b: np.zeros_like(a)),
    (ck.OP_ONES, lambda a, b: np.full_like(a, 0xFFFFFFFF)),
    (ck.OP_AND, lambda a, b: a & b),
    (ck.OP_OR, lambda a, b: a | b),
    (ck.OP_XOR, lambda a, b: a ^ b),
    (ck.OP_ANDNOT, lambda a, b: a & ~b),
    (ck.OP_NOT, lambda a, b: ~a),
])
def test_every_opcode(op, want):
    rng = np.random.default_rng(op)
    a, b = words(rng, (3, 64)), words(rng, (3, 64))
    pb = ck.ProgramBuilder(3, 64)
    ra, rb = pb.load(pb.plane("a", t(a))), pb.load(pb.plane("b", t(b)))
    res, counts = ck.plan_eval(pb.build(pb.op(op, ra, rb)), True, True)
    np.testing.assert_array_equal(res.numpy().view(np.uint32), want(a, b))
    np.testing.assert_array_equal(
        counts.numpy(), np.bitwise_count(want(a, b)).sum(-1))


def _unrolled_walk(pb, b, first, pred_bits, depth, mode, allow_eq):
    """The walk as set algebra over loaded planes, one plane at a time:
    what OP_BSI replaces."""
    keep = pb.const(False)
    t = pb.reg()
    if pred_bits[depth]:
        if mode == ck.MODE_LT:
            pb.op(ck.OP_OR, keep, b, dst=keep)
        pb.emit(ck.OP_ZERO, b)
    for i in range(depth - 1, -1, -1):
        s = pb.load(first + i)
        if mode == ck.MODE_LT and pred_bits[i]:
            pb.op(ck.OP_ANDNOT, b, s, dst=t)
            pb.op(ck.OP_OR, keep, t, dst=keep)
        elif mode == ck.MODE_GT and not pred_bits[i]:
            pb.op(ck.OP_AND, b, s, dst=t)
            pb.op(ck.OP_OR, keep, t, dst=keep)
        pb.op(ck.OP_AND if pred_bits[i] else ck.OP_ANDNOT, b, s, dst=b)
        pb.free(s)
    if mode == ck.MODE_EQ:
        return b
    if allow_eq:
        pb.op(ck.OP_OR, keep, b, dst=keep)
    return keep


@pytest.mark.parametrize("depth", [1, 5, 14])
@pytest.mark.parametrize("mode", [ck.MODE_EQ, ck.MODE_LT, ck.MODE_GT])
@pytest.mark.parametrize("allow_eq", [False, True])
def test_bsi_opcode_matches_unrolled_set_algebra(depth, mode, allow_eq):
    rng = np.random.default_rng(depth * 10 + mode)
    x = t(words(rng, (3, depth + 1, 64)))
    for pred in (0, 1, (1 << depth) - 2, 1 << depth, 1 << (depth + 3)):
        bits = [(min(pred, (1 << (depth + 1)) - 1) >> i) & 1
                for i in range(depth + 1)]
        got = []
        for unrolled in (False, True):
            pb = ck.ProgramBuilder(3, 64)
            for j in range(depth + 1):
                pb.plane(j, x[:, j])
            b = pb.load(0)
            r = (_unrolled_walk(pb, b, 1, bits, depth, mode, allow_eq)
                 if unrolled else pb.bsi(b, 1, depth, mode, bits, allow_eq))
            got.append(ck.plan_eval(pb.build(r), True, True))
        assert torch.equal(got[0][0], got[1][0]), f"pred={pred}"
        assert torch.equal(got[0][1], got[1][1]), f"pred={pred}"


def test_strided_planes_of_a_stacked_leaf():
    """Planes of an (S, D+2, W) leaf are strided views; the plain version
    and the wrapper's checks take them as they are."""
    rng = np.random.default_rng(9)
    bsi = words(rng, (2, 5, 64))
    leaf = t(bsi)
    pb = ck.ProgramBuilder(2, 64)
    r = pb.op(ck.OP_XOR, pb.load(pb.plane(1, leaf[:, 1])),
              pb.load(pb.plane(3, leaf[:, 3])))
    res, _ = ck.plan_eval(pb.build(r), True, False)
    np.testing.assert_array_equal(res.numpy().view(np.uint32),
                                  bsi[:, 1] ^ bsi[:, 3])


def test_program_limits():
    pb = ck.ProgramBuilder(1, 8)
    regs = [pb.const(False) for _ in range(ck.NUM_REGS)]
    with pytest.raises(ck.ProgramTooLarge):
        pb.reg()
    pb.free(*regs)
    x = torch.zeros((1, 8), dtype=torch.int32)
    for i in range(ck.MAX_PLANES):
        pb.plane(i, x)
    assert pb.plane(0, x) == 0   # deduplicated by key
    with pytest.raises(ck.ProgramTooLarge):
        pb.plane("one more", x)
    while len(pb.instrs) < ck.MAX_INSTR:
        pb.emit(ck.OP_ZERO, 0)
    with pytest.raises(ck.ProgramTooLarge):
        pb.emit(ck.OP_ZERO, 0)


def test_wrappers_validate_inputs():
    pb = ck.ProgramBuilder(2, 8)
    pb.load(pb.plane(0, torch.zeros((2, 8), dtype=torch.int64)))
    with pytest.raises(ValueError):
        ck.plan_eval(pb.build(0))
    with pytest.raises(ValueError):
        ck.row_counts(torch.zeros((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        ck.row_counts(torch.zeros((2, 3, 8), dtype=torch.int32),
                      torch.zeros((1, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        tbw.count_and(torch.zeros(4, dtype=torch.int32),
                      torch.zeros(5, dtype=torch.int32))


def test_cpu_tensors_launch_nothing():
    ck.reset_launches()
    x = torch.ones((2, 3, 8), dtype=torch.int32)
    tbw.per_shard_row_counts(x)
    tbw.popcount(x)
    assert ck.launches() == {"plan_eval": 0, "row_counts": 0,
                             "bsi_sum_planes": 0, "bsi_min_max": 0,
                             "pair_counts": 0, "bsi_sum_groups": 0,
                             "bsi_decode": 0, "bsi_decode_gather": 0,
                             "percentile_counts": 0, "var_moments": 0,
                             "corr_moments": 0}
