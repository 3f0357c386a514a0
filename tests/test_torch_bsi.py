"""BSI range comparators of the port against featurebase_tpu's bsi_traced.

Both the port's plain torch comparators and their lowering to kernel-A
programs (run through the plain interpreter on the CPU) must give exactly
the JAX package's words, at depths 1, 14, 31 and 32, with predicates taken
from the stored values, at the edges of the range, and past it (saturating
through encode_pred's virtual plane)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurebase_tpu.ops import bsi_traced as jbst
from featurebase_tpu_torch.ops import bsi_traced as tbst
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import lowering

S, W = 2, 64
N = S * W * 32
DEPTHS = [1, 14, 31, 32]
OPS = ["eq", "neq", "lt", "lte", "gt", "gte"]


def pack(bits: np.ndarray) -> np.ndarray:
    """(N,) bool -> (S, W) uint32 words."""
    return np.packbits(bits, bitorder="little").view(np.uint32).reshape(S, W)


@functools.lru_cache(maxsize=None)
def dataset(depth: int):
    rng = np.random.default_rng(depth)
    top = (1 << depth) - 1
    vals = rng.integers(-top, top + 1, size=N, dtype=np.int64)
    vals[:4] = [0, top, -top, 1]
    exists = rng.random(N) < 0.8
    mag = np.abs(vals).astype(np.uint64)
    slices = np.stack([pack(((mag >> np.uint64(i)) & np.uint64(1)).astype(bool)
                             & exists) for i in range(depth)], axis=1)
    ex, sign = pack(exists), pack((vals < 0) & exists)
    filt = pack(rng.random(N) < 0.7)
    preds = sorted({0, 1, -1, top, -top, top + 1, -(top + 1), 3 * top + 5,
                    -(3 * top + 5), int(vals[7]), int(vals[8]), int(vals[9])})
    return slices, ex, sign, filt, preds


def jax_op(op, slices, ex, sign, filt, pred, depth):
    bits, neg = jbst.encode_pred(pred, depth)
    args = (jnp.asarray(slices), jnp.asarray(ex), jnp.asarray(sign),
            jnp.asarray(filt), jnp.asarray(bits), jnp.asarray(neg), depth)
    if op == "eq":
        return np.asarray(jbst.range_eq_t(*args))
    if op == "neq":
        return np.asarray(jbst.range_neq_t(*args))
    fn = jbst.range_lt_t if op in ("lt", "lte") else jbst.range_gt_t
    return np.asarray(fn(*args, op.endswith("e")))


def torch_op(op, slices, ex, sign, filt, pred, depth):
    bits, neg = tbst.encode_pred(pred, depth)
    args = (slices, ex, sign, filt, bits, int(neg), depth)
    if op == "eq":
        return tbst.range_eq_t(*args)
    if op == "neq":
        return tbst.range_neq_t(*args)
    fn = tbst.range_lt_t if op in ("lt", "lte") else tbst.range_gt_t
    return fn(*args, op.endswith("e"))


def lowered(op, leaf, pred, depth):
    lp = tbst.LeafPlanes("v", leaf)
    bits, neg = tbst.encode_pred(pred, depth)
    if op == "eq":
        e = tbst.expr_eq(lp, bits, int(neg), depth)
    elif op == "neq":
        e = tbst.expr_neq(lp, bits, int(neg), depth)
    elif op in ("lt", "lte"):
        e = tbst.expr_lt(lp, bits, int(neg), depth, op == "lte")
    else:
        e = tbst.expr_gt(lp, bits, int(neg), depth, op == "gte")
    words, _ = ck.plan_eval(lowering.program(e, S, W), True, False)
    return words


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def u32(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("op", OPS)
def test_comparator_and_lowering(depth, op):
    slices, ex, sign, filt, preds = dataset(depth)
    ones = np.full_like(ex, 0xFFFFFFFF)
    leaf = t(np.concatenate([ex[:, None], sign[:, None], slices], axis=1))
    for pred in preds:
        want = jax_op(op, slices, ex, sign, filt, pred, depth)
        got = torch_op(op, t(slices), t(ex), t(sign), t(filt), pred, depth)
        np.testing.assert_array_equal(u32(got), want, err_msg=f"pred={pred}")
        want1 = jax_op(op, slices, ex, sign, ones, pred, depth)
        np.testing.assert_array_equal(u32(lowered(op, leaf, pred, depth)),
                                      want1, err_msg=f"lowered pred={pred}")


@pytest.mark.parametrize("depth", DEPTHS)
def test_between_and_lowering(depth):
    slices, ex, sign, filt, preds = dataset(depth)
    ones = np.full_like(ex, 0xFFFFFFFF)
    leaf = t(np.concatenate([ex[:, None], sign[:, None], slices], axis=1))
    for lo, hi in zip(preds, preds[len(preds) // 2:] + preds[:1]):
        lb, ln = jbst.encode_pred(lo, depth)
        hb, hn = jbst.encode_pred(hi, depth)

        def jax_betw(f):
            return np.asarray(jbst.range_between_t(
                jnp.asarray(slices), jnp.asarray(ex), jnp.asarray(sign),
                jnp.asarray(f), jnp.asarray(lb), jnp.asarray(ln),
                jnp.asarray(hb), jnp.asarray(hn), depth))
        got = tbst.range_between_t(t(slices), t(ex), t(sign), t(filt), lb,
                                   int(ln), hb, int(hn), depth)
        np.testing.assert_array_equal(u32(got), jax_betw(filt))
        prog = lowering.program(tbst.expr_between(
            tbst.LeafPlanes("v", leaf), lb, int(ln), hb, int(hn), depth), S, W)
        words, _ = ck.plan_eval(prog, True, False)
        np.testing.assert_array_equal(u32(words), jax_betw(ones),
                                      err_msg=f"lo={lo} hi={hi}")


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("pred", [0, 5, -5, (1 << 33)])
def test_encode_pred(depth, pred):
    jb, jn = jbst.encode_pred(pred, depth)
    tb, tn = tbst.encode_pred(pred, depth)
    np.testing.assert_array_equal(tb, jb)
    assert int(tn) == int(jn)


def test_lowering_fits_the_kernel_at_depth_32():
    """A between at the deepest BSI the engine stores stays inside the
    kernel's program limits."""
    leaf = torch.zeros((1, 34, 8), dtype=torch.int32)
    lb, ln = tbst.encode_pred(-12345, 32)
    hb, hn = tbst.encode_pred((1 << 32) - 7, 32)
    prog = lowering.program(tbst.expr_between(
        tbst.LeafPlanes("v", leaf), lb, int(ln), hb, int(hn), 32), 1, 8)
    assert len(prog.planes) == 34
    assert len(prog.instrs) <= ck.MAX_INSTR
