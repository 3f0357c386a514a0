"""Bitmap expressions lowered to kernel-A programs that fit its limits.

Kernel A (ops/cuda_kernels.py ``plan_eval``) runs a program of at most
MAX_INSTR instruction words over at most MAX_PLANES planes with NUM_REGS
registers.  The JAX package has no such limits (XLA compiles any tree), so
every plan it answers must lower here too.  Two measures make it so:

- **Sethi-Ullman order.**  Each node's register need is computed before
  any code is emitted, and the children of a set operation are emitted
  neediest first: a chain nested to any depth on one side needs two
  registers, not one a level.
- **Spills.**  An expression that still does not fit is cut: a subtree that
  fits is evaluated on its own to (S, W) words (one more kernel-A launch in
  word mode) and enters the rest as a plane, as a Shift operand already
  does.  The cut is deterministic, so a plan always lowers the same way:
  the first child that does not fit is shrunk first; then, while the node
  does not fit, its child with the most planes (the first on ties) is
  spilled; a node whose children are all planes folds a run of
  MAX_PLANES // 2 of them (the subtrahends of an andnot, under OR) into one.

Expressions are tuples:

  ("plane", key, tensor)          an (S, W) int32 plane; equal keys share
                                  one plane of the program
  ("or" | "and" | "xor", e, ...)  set algebra over two or more children
  ("andnot", m, s1, s2, ...)      m & ~s1 & ~s2 ...
  ("walk", src, planes, mode, bits, allow_eq)
                                  one OP_BSI over `planes` (magnitude plane
                                  0 first, each a "plane" expression),
                                  applied to src in place, with predicate
                                  bits (one more than planes: the virtual
                                  plane's last)
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Tuple

import torch

from featurebase_tpu_torch.ops import cuda_kernels as ck

_SET_OPS = {"or": ck.OP_OR, "and": ck.OP_AND, "xor": ck.OP_XOR}


def need(e, memo: Dict[int, int] = None) -> int:
    """Registers that emitting `e` takes (its Sethi-Ullman number)."""
    memo = {} if memo is None else memo
    key = id(e)
    if key in memo:
        return memo[key]
    kind = e[0]
    if kind == "plane":
        n = 1
    elif kind == "walk":
        n = need(e[1], memo)
    elif kind in _SET_OPS:
        n = _chain_need([need(c, memo) for c in e[1:]])
    else:   # andnot
        n = min(_andnot_needs([need(c, memo) for c in e[1:]]))
    memo[key] = n
    return n


def _chain_need(needs: List[int]) -> int:
    """A chain that holds its accumulator while it emits each further
    child, neediest first."""
    s = sorted(needs, reverse=True)
    return max(s[0], 1 + s[1]) if len(s) > 1 else s[0]


def _andnot_needs(needs: List[int]) -> Tuple[int, int]:
    """(minuend first, subtrahends first): the needs of an andnot's two
    orders.  The second ORs the subtrahends, then takes the minuend."""
    m, subs = needs[0], needs[1:]
    first = max(m, 1 + max(subs))
    return first, max(_chain_need(subs), 1 + m)


def _by_need(children, memo) -> list:
    """Children neediest first; equal needs keep their order."""
    return sorted(children, key=lambda c: -need(c, memo))


def emit(pb: ck.ProgramBuilder, e, memo: Dict[int, int] = None) -> int:
    """Emit `e` into `pb` in Sethi-Ullman order; returns its register (the
    caller frees it)."""
    memo = {} if memo is None else memo
    kind = e[0]
    if kind == "plane":
        return pb.load(pb.plane(e[1], e[2]))
    if kind == "walk":
        _, src, planes, mode, bits, allow_eq = e
        r = emit(pb, src, memo)
        ids = [pb.plane(p[1], p[2]) for p in planes]
        if ids != list(range(ids[0], ids[0] + len(ids))):
            # planes registered apart earlier: a fresh consecutive run
            ids = [pb.plane(("walk", id(e), p[1]), p[2]) for p in planes]
        return pb.bsi(r, ids[0], len(planes), mode, bits, allow_eq)
    if kind in _SET_OPS:
        return _emit_chain(pb, _SET_OPS[kind], _by_need(e[1:], memo), memo)
    needs = [need(c, memo) for c in e[1:]]
    first, subs_first = _andnot_needs(needs)
    subs = _by_need(e[2:], memo)
    if first <= subs_first:
        return _emit_chain(pb, ck.OP_ANDNOT, [e[1]] + subs, memo)
    u = _emit_chain(pb, ck.OP_OR, subs, memo)
    m = emit(pb, e[1], memo)
    pb.op(ck.OP_ANDNOT, m, u, dst=m)
    pb.free(u)
    return m


def _emit_chain(pb, op: int, children, memo) -> int:
    acc = emit(pb, children[0], memo)
    for c in children[1:]:
        r = emit(pb, c, memo)
        pb.op(op, acc, r, dst=acc)
        pb.free(r)
    return acc


def program(e, S: int, W: int, limits: bool = True) -> ck.Program:
    """`e` as a program; with limits=False, one that may exceed kernel A's
    limits (to measure it)."""
    pb = ck.ProgramBuilder(S, W, limits=limits)
    return pb.build(emit(pb, e))


def _size(e, S: int, W: int) -> Tuple[int, int, int]:
    """(planes, registers, instruction words) of `e` as a program."""
    prog = program(e, S, W, limits=False)
    regs = 1 + max([(w >> 8) & 0xFF for w in _op_words(prog.instrs)]
                   + [prog.result])
    return len(prog.planes), regs, len(prog.instrs)


def _op_words(instrs):
    k = 0
    while k < len(instrs):
        yield instrs[k]
        k += ck.BSI_WORDS if instrs[k] & 0xFF == ck.OP_BSI else 1


def fits(e, S: int, W: int) -> bool:
    try:
        planes, regs, words = _size(e, S, W)
    except ck.ProgramTooLarge:     # past even the measuring builder's fields
        return False
    return planes <= ck.MAX_PLANES and regs <= ck.NUM_REGS \
        and words <= ck.MAX_INSTR


def lower(e, S: int, W: int,
          eval_words: Callable[[ck.Program], torch.Tensor]) -> ck.Program:
    """A program of `e` within kernel A's limits.  Subtrees that must be
    cut off are evaluated first with `eval_words` (a program -> its (S, W)
    result words) and enter as planes."""
    serial = itertools.count()

    def spill(sub):
        words = eval_words(program(shrink(sub), S, W))
        return ("plane", ("spill", next(serial)), words)

    def shrink(x):
        if fits(x, S, W):
            return x
        kind = x[0]
        if kind == "walk":
            src = shrink(x[1])
            y = (kind, src, *x[2:])
            if fits(y, S, W) or src[0] == "plane":
                return y
            return (kind, spill(src), *x[2:])
        kids = [shrink(c) for c in x[1:]]
        while True:
            y = (kind, *kids)
            if fits(y, S, W):
                return y
            cand = [i for i, c in enumerate(kids) if c[0] != "plane"]
            if cand:
                i = max(cand, key=lambda i: (_size(kids[i], S, W)[0], -i))
                kids[i] = spill(kids[i])
                continue
            lo = 1 if kind == "andnot" else 0
            run = kids[lo:lo + ck.MAX_PLANES // 2]
            op = "or" if kind == "andnot" else kind
            kids[lo:lo + len(run)] = [spill((op, *run)) if len(run) > 1
                                      else run[0]]

    return program(shrink(e), S, W)


def run_words(e, S: int, W: int) -> torch.Tensor:
    """`e` evaluated to (S, W) words with kernel A, spills included."""
    def words(prog):
        return ck.plan_eval(prog, want_words=True)[0]
    return words(lower(e, S, W, words))
