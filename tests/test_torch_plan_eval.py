"""Kernel A's program format and its BSI instruction, on the CPU.

OP_BSI runs a whole unsigned BSI walk as one instruction.  Through the
plain interpreter (``plan_eval`` on CPU tensors) it must give exactly the
JAX package's traced walks (featurebase_tpu/ops/bsi_traced.py u_eq_t,
u_lt_t, u_gt_t) at depths 1, 14, 31 and 32, for positive, negative and
saturating predicates, with and without allow_eq.  The program-format tests
pin the payload encoding, the limits and the checks that the CUDA launcher
repeats (csrc/bitmap_kernels.cu valid_program).  The CUDA kernel itself is
held against the plain interpreter on the card by chip_smoke.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurebase_tpu.ops import bsi_traced as jbst
from featurebase_tpu_torch.ops import bitwise as tbw
from featurebase_tpu_torch.ops import bsi_traced as tbst
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import lowering

S, W = 2, 96          # 96 words: not a multiple of the kernel's tile
DEPTHS = [1, 14, 31, 32]
MODES = {"eq": (ck.MODE_EQ, False), "lt": (ck.MODE_LT, False),
         "lte": (ck.MODE_LT, True), "gt": (ck.MODE_GT, False),
         "gte": (ck.MODE_GT, True)}


def words(rng, shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@functools.lru_cache(maxsize=None)
def planes(depth: int):
    """(S, depth + 1, W) words: plane 0 the side to walk, then the
    magnitude slices."""
    return words(np.random.default_rng(1000 + depth), (S, depth + 1, W))


def preds(depth: int):
    top = (1 << depth) - 1
    return sorted({0, 1, top // 3, top, top + 1, 5 * top + 3, -1, -(top // 7),
                   -top, -(top + 1)})


def jax_walk(mode: str, slices, base, bits, depth):
    args = (jnp.asarray(slices), jnp.asarray(base), jnp.asarray(bits), depth)
    if mode == "eq":
        return np.asarray(jbst.u_eq_t(*args))
    fn = jbst.u_lt_t if mode.startswith("lt") else jbst.u_gt_t
    return np.asarray(fn(*args, mode.endswith("e")))


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_bsi_instruction_matches_jax_walk(depth, mode):
    arr = planes(depth)
    leaf = t(arr)
    code, allow_eq = MODES[mode]
    for pred in preds(depth):
        bits, _ = tbst.encode_pred(pred, depth)   # |pred|, saturated
        pb = ck.ProgramBuilder(S, W)
        side = pb.load(pb.plane("side", leaf[:, 0]))
        first = pb.plane(0, leaf[:, 1])
        for i in range(1, depth):
            pb.plane(i, leaf[:, 1 + i])
        r = pb.bsi(side, first, depth, code, bits, allow_eq)
        got, counts = ck.plan_eval(pb.build(r), True, True)
        want = jax_walk(mode, arr[:, 1:], arr[:, 0], bits, depth)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want,
                                      err_msg=f"pred={pred}")
        np.testing.assert_array_equal(
            counts.numpy(), np.bitwise_count(want).sum(-1).astype(np.int64))


@pytest.mark.parametrize("first,depth,mode,allow_eq,pred", [
    (0, 1, ck.MODE_EQ, False, 1),
    (2, 14, ck.MODE_GT, False, 5000),
    (2, 14, ck.MODE_LT, True, 99),
    (5, 31, ck.MODE_LT, False, (1 << 31) - 1),
    (14, 32, ck.MODE_GT, True, (1 << 32) - 7),
    (16, 32, ck.MODE_EQ, False, 1 << 40),   # saturates: top bit set
])
def test_bsi_payload_round_trips(first, depth, mode, allow_eq, pred):
    bits, _ = tbst.encode_pred(pred, depth)
    mask, info = ck.encode_bsi(first, depth, mode, bits, allow_eq)
    assert 0 <= mask < 1 << 32 and 0 <= info < 1 << 20
    f, d, m, b, e = ck.decode_bsi(mask, info)
    assert (f, d, m, e) == (first, depth, mode, allow_eq)
    np.testing.assert_array_equal(b, bits)


@pytest.mark.parametrize("first,depth,mode,nbits,bad_bit", [
    (0, 0, ck.MODE_EQ, 1, False),            # depth 0
    (0, 33, ck.MODE_EQ, 34, False),          # deeper than MAX_DEPTH
    (0, 14, ck.MODE_EQ, 14, False),          # missing the virtual bit
    (0, 14, 3, 15, False),                   # no such mode
    (ck.MAX_PLANES - 3, 4, ck.MODE_LT, 5, False),   # planes past the limit
    (0, 14, ck.MODE_GT, 15, True),           # a bit that is not 0 or 1
])
def test_encode_bsi_refuses(first, depth, mode, nbits, bad_bit):
    bits = [0] * nbits
    if bad_bit:
        bits[3] = 2
    with pytest.raises(ValueError):
        ck.encode_bsi(first, depth, mode, bits)


def test_bsi_counts_against_the_instruction_limit():
    pb = ck.ProgramBuilder(1, 8)
    bits, _ = tbst.encode_pred(3, 2)
    while len(pb.instrs) < ck.MAX_INSTR - ck.BSI_WORDS:
        pb.emit(ck.OP_ZERO, 0)
    pb.bsi(0, 0, 2, ck.MODE_EQ, bits)        # fills the program exactly
    assert len(pb.instrs) == ck.MAX_INSTR
    pb2 = ck.ProgramBuilder(1, 8)
    while len(pb2.instrs) < ck.MAX_INSTR - 2:
        pb2.emit(ck.OP_ZERO, 0)
    with pytest.raises(ck.ProgramTooLarge):
        pb2.bsi(0, 0, 2, ck.MODE_EQ, bits)
    assert len(pb2.instrs) == ck.MAX_INSTR - 2   # nothing half-written


def _bsi_program(n_planes=16, depth=14):
    x = torch.zeros((2, 8), dtype=torch.int32)
    pb = ck.ProgramBuilder(2, 8)
    for i in range(n_planes):
        pb.plane(i, x)
    r = pb.load(0)
    bits, _ = tbst.encode_pred(5000, depth)
    pb.bsi(r, 2, depth, ck.MODE_GT, bits)
    return pb.build(r)


def _set(i, w):
    def f(prog):
        prog.instrs[i] = w(prog.instrs[i])
    return f


@pytest.mark.parametrize("name,mutate", [
    ("unknown opcode", _set(0, lambda w: (w & ~0xFF) | 9)),
    ("destination register past the file", _set(0, lambda w: w | (12 << 8))),
    ("load of a plane past the list", _set(0, lambda w: w | (16 << 16))),
    ("load with a second operand", _set(0, lambda w: w | (1 << 24))),
    ("BSI source register past the file",
     _set(1, lambda w: (w & ~(0xFF << 16)) | (12 << 16))),
    ("BSI depth 0", _set(3, lambda w: w & ~(0xFF << 8))),
    ("BSI depth 33", _set(3, lambda w: (w & ~(0xFF << 8)) | (33 << 8))),
    ("BSI mode 3", _set(3, lambda w: w | (3 << 16))),
    ("BSI planes past the list", _set(3, lambda w: (w & ~0xFF) | 3)),
    ("BSI predicate bits above depth", _set(2, lambda w: w | (1 << 20))),
    ("BSI reserved payload bits", _set(3, lambda w: w | (1 << 21))),
    ("a word past 32 bits", _set(2, lambda w: w | (1 << 32))),
    ("BSI payload cut off", lambda prog: prog.instrs.pop()),
    ("result register past the file",
     lambda prog: setattr(prog, "result", ck.NUM_REGS)),
    ("empty program", lambda prog: prog.instrs.clear()),
])
def test_validate_refuses_bad_programs(name, mutate):
    prog = _bsi_program()
    ck.validate(prog)
    mutate(prog)
    with pytest.raises(ValueError):
        ck.validate(prog)
    with pytest.raises(ValueError):
        ck.plan_eval(prog)


def test_program_fits_the_parameter_space():
    """sizeof(Program) in csrc/bitmap_kernels.cu: plane pointers, strides,
    instruction words and three ints, under 4 KB with room for the other
    arguments."""
    size = ck.MAX_PLANES * 8 * 2 + ck.MAX_INSTR * 4 + 3 * 4
    assert size + 128 < 4096


@pytest.mark.parametrize("depth", DEPTHS)
def test_lowering_reads_each_plane_once(depth):
    """A between is two OP_BSI walks over the same consecutive slices; each
    of its depth + 2 planes is one plane of the program, so the kernel
    stages it once per tile."""
    leaf = torch.zeros((1, depth + 2, 8), dtype=torch.int32)
    lb, ln = tbst.encode_pred(-3, depth)
    hb, hn = tbst.encode_pred(5, depth)
    prog = lowering.program(tbst.expr_between(
        tbst.LeafPlanes("v", leaf), lb, int(ln), hb, int(hn), depth), 1, 8)
    ck.validate(prog)
    assert len(prog.planes) == depth + 2
    walks = [w for w in prog.instrs if w & 0xFF == ck.OP_BSI]
    assert len(walks) == 2
    assert len(prog.instrs) <= 24   # independent of depth


def test_slices_must_be_consecutive_planes():
    """One OP_BSI names its slices as a run of consecutive planes: slices
    registered apart earlier are registered again as a fresh run, and the
    walk gives the words it gives alone."""
    rng = np.random.default_rng(6)
    leaf = t(words(rng, (1, 6, 8)))
    lp = tbst.LeafPlanes("v", leaf)
    walk = ("walk", lp.exists(), lp.mags(0, 4), ck.MODE_GT,
            (1, 0, 1, 0, 0), False)
    pb = ck.ProgramBuilder(1, 8)
    pb.plane(lp.mags(2, 3)[0][1], leaf[:, 4])    # slice 2 first, alone
    prog = pb.build(lowering.emit(pb, walk))
    ck.validate(prog)
    k = next(i for i, w in enumerate(prog.instrs) if w & 0xFF == ck.OP_BSI)
    first, depth = ck.decode_bsi(*prog.instrs[k + 1:k + 3])[:2]
    assert depth == 4 and all(torch.equal(prog.planes[first + i],
                                          leaf[:, 2 + i]) for i in range(4))
    assert torch.equal(ck.plan_eval(prog, True)[0],
                       ck.plan_eval(lowering.program(walk, 1, 8), True)[0])


@pytest.mark.parametrize("n", [1, 37, 96, 1000, 1027, 4096])
def test_flat_programs(n):
    """bitwise.popcount and count_and lower to S = 1 programs over a flat
    view of any length, the irregular ones included."""
    rng = np.random.default_rng(n)
    a, b = words(rng, (n,)), words(rng, (n,))
    assert int(tbw.popcount(t(a))) == int(np.bitwise_count(a).sum())
    assert int(tbw.count_and(t(a), t(b))) == \
        int(np.bitwise_count(a & b).sum())


def _random_program(rng, n_steps: int):
    """A register program with reused and overwritten registers, reading
    only registers it has written."""
    x = t(words(rng, (S, 6, W)))
    pb = ck.ProgramBuilder(S, W)
    for j in range(6):
        pb.plane(j, x[:, j])
    live = []
    for _ in range(n_steps):
        d = int(rng.integers(ck.NUM_REGS))
        kind = rng.integers(5) if live else 0
        if kind == 0:
            pb.emit(ck.OP_LOAD, d, int(rng.integers(6)))
        elif kind == 1:
            pb.emit(int(rng.choice([ck.OP_ZERO, ck.OP_ONES])), d)
        elif kind == 2:
            pb.emit(ck.OP_NOT, d, int(rng.choice(live)))
        elif kind == 3:
            depth = int(rng.integers(1, 5))
            mask, info = ck.encode_bsi(int(rng.integers(0, 6 - depth + 1)),
                                       depth, int(rng.integers(3)),
                                       rng.integers(0, 2, depth + 1),
                                       bool(rng.integers(2)))
            pb.instrs += [ck.OP_BSI | (d << 8) | (int(rng.choice(live)) << 16),
                          mask, info]
        else:
            op = int(rng.choice([ck.OP_AND, ck.OP_OR, ck.OP_XOR,
                                 ck.OP_ANDNOT]))
            pb.emit(op, d, int(rng.choice(live)), int(rng.choice(live)))
        live = sorted(set(live) | {d})
    return pb, int(rng.choice(live))


@pytest.mark.parametrize("seed", range(12))
def test_compact_registers_keeps_the_answer(seed):
    rng = np.random.default_rng(seed)
    pb, result = _random_program(rng, int(rng.integers(3, 40)))
    raw = ck.Program(list(pb.instrs), list(pb.planes), result, S, W)
    prog = pb.build(result)
    ck.validate(prog)
    assert len(prog.instrs) == len(raw.instrs)
    used = {(w >> 8) & 0xFF for w in _op_words(prog)} | {prog.result}
    assert max(used) <= max({(w >> 8) & 0xFF for w in _op_words(raw)}
                            | {result})
    want, want_c = ck.plan_eval_plain(raw, True, True)
    got, got_c = ck.plan_eval_plain(prog, True, True)
    assert torch.equal(got, want) and torch.equal(got_c, want_c)


def _op_words(prog):
    k = 0
    while k < len(prog.instrs):
        w = prog.instrs[k]
        yield w
        k += ck.BSI_WORDS if w & 0xFF == ck.OP_BSI else 1


def test_compact_registers_uses_the_fewest():
    """The slice's AND and BSI programs fit the kernel's 2-register file,
    a between its 4-register file."""
    a = torch.zeros((1, 8), dtype=torch.int32)
    pb = ck.ProgramBuilder(1, 8)
    r = pb.op(ck.OP_AND, pb.load(pb.plane(0, a)), pb.load(pb.plane(1, a)))
    assert max(w >> 8 & 0xFF for w in pb.build(r).instrs) == 1
    leaf = tbst.LeafPlanes("v", torch.zeros((1, 16, 8), dtype=torch.int32))
    for e, regs in ((tbst.expr_gt(leaf, tbst.encode_pred(5000, 14)[0], 0,
                                  14, False), 2),
                    (tbst.expr_between(leaf, tbst.encode_pred(1, 14)[0], 0,
                                       tbst.encode_pred(99, 14)[0], 0, 14),
                     4)):
        prog = lowering.program(e, 1, 8)
        assert max((w >> 8) & 0xFF for w in _op_words(prog)) < regs


def test_compact_registers_leaves_bad_programs_alone():
    """A read before any write is left for validate and the interpreter."""
    instrs = [ck.OP_AND | (0 << 8) | (3 << 16) | (4 << 24)]
    assert ck.compact_registers(instrs, 0) == (instrs, 0)
