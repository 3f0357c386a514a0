"""Hopper kernels for the bitmap engine, with their plain PyTorch versions.

Counterpart of featurebase_tpu/ops/pallas_kernels.py.  The three Pallas
kernels there become two CUDA kernels (csrc/bitmap_kernels.cu, built by
ops/build.py and loaded with ctypes):

- ``plan_eval`` (kernel A) evaluates a lowered bitmap plan (a short program
  over leaf planes, built with ``ProgramBuilder``) and writes the result
  words, per-shard counts, or both.  It replaces ``count_and_pallas``
  (pallas_kernels.py:135-160): ``count_and`` is the program
  ``[load 0, load 1, and]``.  A BSI comparison is one ``OP_BSI``
  instruction that walks the magnitude planes.  ``ProgramBuilder.build``
  renumbers registers to the fewest, and the kernel picks its smallest
  register file that holds them.  Bound: bytes — TMA stages each plane of
  a tile once, and count mode writes nothing but S counts.
- ``row_counts`` (kernel B') gives per-row popcounts of S x R rows,
  optionally ANDed with a filter row a shard.  It replaces
  ``count_and_rows_pallas`` (:172-195) and ``popcount_rows_pallas``
  (:203-222).  Rows are named by a table of addresses, so
  ``row_counts_sharded`` reads every shard's fragment mirror in place in
  one launch, and ``row_counts`` takes a stacked (S, R, W) tile as the
  table of its rows.  Bound: bytes — every row and filter word is read
  once (the header note of the source).

Two more kernels (csrc/bsi_kernels.cu) have no Pallas original: they are
the counterparts of XLA programs of featurebase_tpu/ops/bsi.py, whose work
is popcounts and bit-sliced descents that torch has no op for:

- ``bsi_sum_planes`` (kernel C') replaces ``sum_planes_stacked``
  (bsi.py:378): Sum's per-plane popcounts over a BSI group under a filter.
- ``bsi_min_max`` (kernel D') replaces ``min_max_stacked`` (bsi.py:399) and
  the per-shard descents of ``minmax_parts_kernel`` (:200-278): per shard
  the two greedy descents a Min or a Max needs, without a decode.
Planes are named by a table of addresses, so ``bsi_sum_planes_sharded`` and
``bsi_min_max_sharded`` read every shard's fragment mirror in place in one
launch, and ``bsi_sum_planes`` and ``bsi_min_max`` take a stacked (S, D + 2,
W) group as the table of its planes.  Their plain versions are in
ops/bsi.py and ``*_sharded_plain`` below.  Bound: bytes — each reads the
group and the filter once.

Two more (csrc/group_kernels.cu) serve GroupBy, again for XLA programs.
Each is one AND-popcount product over every shard in one launch, its
operands read where they live through a table of row addresses:

- ``pair_counts`` (kernel E) replaces ``stacked_pair_counts``
  (bitwise.py:175) and, at S = 1, ``count_and_pairs`` (:123): the (F, R)
  intersection counts of F masks with R rows, under an optional filter.
- ``bsi_sum_groups`` (kernel F) replaces ``sum_groups_stacked``
  (bsi.py:611) and, at S = 1, ``sum_groups_kernel`` (:333): kernel C's
  2D + 1 counters for each of G group masks, which it forms on chip from
  one to three dimensions.
``pair_counts_sharded`` and ``bsi_sum_groups_sharded`` take per-shard
tiles (the fragments' device mirrors) and slot tables; ``pair_counts``
and ``bsi_sum_groups`` take stacked tensors, with tables into them.  The
product runs on the tensor cores (``mma.sync`` .b1 .and.popc).  Bound:
bytes (the header note of the source).  The plain versions are
``pair_counts_plain`` and ``*_sharded_plain`` below and
``sum_groups_plain`` in ops/bsi.py.

Kernel H' (csrc/moments_kernels.cu) serves SQL's VAR and CORR, again for
XLA programs:

- ``var_moments`` replaces ``var_moments_stacked`` (bsi.py:782) and
  ``corr_moments`` replaces ``corr_moments_stacked`` (:815): every raw
  count of a Var or a Corr in one launch, a tensor-core product of classes
  of one or two BSI groups formed on chip under the filter (plane & P,
  plane & sign & P, P, sign & P, with P = exists [& exists] [& filter]),
  each count a cell or a difference of cells (``moments_layout``).
``var_moments_sharded`` and ``corr_moments_sharded`` read per-shard
groups in place.  The plain versions are ``var_moments_plain`` and
``corr_moments_plain`` in ops/bsi.py.

Three more (csrc/decode_kernels.cu) decode BSI values, again for XLA
programs of featurebase_tpu/ops/bsi.py:

- ``bsi_decode`` (kernel G'') replaces ``decode_values`` (bsi.py:759) and
  ``decode_values_jit`` (:482): S shards' groups to (S, 2^20) int32 values.
- ``bsi_decode_gather`` (kernel G''') replaces ``decode_gather`` (:367):
  each shard's values and exists bits at its columns.
- ``percentile_counts`` (kernel I) replaces the counting passes of
  ``percentile_fused`` (:491-607): a histogram of the present values over
  the bins of K sorted thresholds, with their min and max.
G'' and G''' name planes by a table of addresses, as C' and D' do:
``bsi_decode_sharded`` and ``bsi_decode_gather_sharded`` read every shard's
mirror in place in one launch, ``bsi_decode`` takes a stacked group as an
affine table, and ``bsi_decode_gather`` one shard's group.
Bound: bytes (the header note of the source).  Their plain versions are in
ops/decode.py, with the Percentile bisection that drives kernel I.

Words are ``torch.int32`` tensors holding the uint32 bit patterns.  Each
wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.  ``launches`` on each wrapper counts
kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SOURCE = "bitmap_kernels.cu"
BSI_SOURCE = "bsi_kernels.cu"
GROUP_SOURCE = "group_kernels.cu"
MOMENTS_SOURCE = "moments_kernels.cu"
DECODE_SOURCE = "decode_kernels.cu"

# Program limits and opcodes; must match csrc/bitmap_kernels.cu.
MAX_INSTR = 640        # instruction words, BSI payloads included
MAX_PLANES = 48
NUM_REGS = 12
MAX_DEPTH = 32         # magnitude planes in one OP_BSI walk
CHUNK_QUANTUM = 128    # words; the kernel's tiles are multiples of it

(OP_LOAD, OP_ZERO, OP_ONES, OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_NOT,
 OP_BSI) = range(9)
MODE_EQ, MODE_LT, MODE_GT = range(3)
BSI_WORDS = 3          # OP_BSI and its two payload words


class ProgramTooLarge(Exception):
    """A plan needs more instruction words, planes or registers than the
    kernel holds (MAX_INSTR / MAX_PLANES / NUM_REGS)."""


class Program:
    """A lowered plan: instruction words over registers, the leaf planes
    they read ((S, W) int32 views, unit stride along W), and the result
    register."""

    __slots__ = ("instrs", "planes", "result", "S", "W")

    def __init__(self, instrs: List[int], planes: List[torch.Tensor],
                 result: int, S: int, W: int):
        self.instrs = instrs
        self.planes = planes
        self.result = result
        self.S = S
        self.W = W


def encode_bsi(first: int, depth: int, mode: int, pred_bits,
               allow_eq: bool = False, max_planes: int = MAX_PLANES
               ) -> Tuple[int, int]:
    """The two payload words of OP_BSI: a walk over planes first ..
    first + depth - 1 (magnitude planes 0 .. depth - 1) with predicate bits
    pred_bits[0 .. depth] (bit `depth` is the virtual all-zero plane).
    max_planes: the planes a program may have (more only for programs that
    are measured, not run: ProgramBuilder(limits=False))."""
    bits = [int(x) for x in pred_bits]
    if not 1 <= depth <= MAX_DEPTH or len(bits) != depth + 1 \
            or any(x not in (0, 1) for x in bits):
        raise ValueError(f"a BSI walk takes depth 1..{MAX_DEPTH} and "
                         f"depth + 1 predicate bits, got depth {depth}, "
                         f"{len(bits)} bits")
    if mode not in (MODE_EQ, MODE_LT, MODE_GT):
        raise ValueError(f"bad BSI mode {mode}")
    if not 0 <= first or first + depth > max_planes:
        raise ValueError(f"BSI planes {first}..{first + depth - 1} out of "
                         f"range")
    mask = sum(b << i for i, b in enumerate(bits[:depth]))
    info = (first | (depth << 8) | (mode << 16) | (int(allow_eq) << 18)
            | (bits[depth] << 19))
    return mask, info


def decode_bsi(mask: int, info: int) -> Tuple[int, int, int, np.ndarray,
                                              bool]:
    """(first, depth, mode, pred_bits, allow_eq) of OP_BSI's payload."""
    first, depth = info & 0xFF, (info >> 8) & 0xFF
    bits = [(mask >> i) & 1 for i in range(depth)] + [(info >> 19) & 1]
    return (first, depth, (info >> 16) & 3, np.array(bits, dtype=np.uint32),
            bool((info >> 18) & 1))


# fields of an instruction word: registers and plane indices up to 255
_FIELD_MAX = 255


class ProgramBuilder:
    """Emits a straight-line program with a free list of registers.  With
    limits=False it takes more planes, registers and words than kernel A
    holds (up to 255 of each field), to measure what an expression needs
    (ops/lowering.py); such a program is never run."""

    def __init__(self, S: int, W: int, limits: bool = True):
        self.S, self.W = S, W
        self.instrs: List[int] = []
        self.planes: List[torch.Tensor] = []
        self._plane_ids: Dict[object, int] = {}
        self._limits = limits
        self._max_planes = MAX_PLANES if limits else _FIELD_MAX
        self._free = list(range((NUM_REGS if limits else _FIELD_MAX) - 1,
                                -1, -1))

    def plane(self, key, tensor: torch.Tensor) -> int:
        """Index of a leaf plane, deduplicated by `key`."""
        pid = self._plane_ids.get(key)
        if pid is None:
            if len(self.planes) >= self._max_planes:
                raise ProgramTooLarge(f"more than {self._max_planes} planes")
            pid = len(self.planes)
            self.planes.append(tensor)
            self._plane_ids[key] = pid
        return pid

    def reg(self) -> int:
        if not self._free:
            raise ProgramTooLarge(f"more than {NUM_REGS} live registers")
        return self._free.pop()

    def free(self, *regs: int) -> None:
        self._free.extend(regs)

    def _words(self, *words: int) -> None:
        if self._limits and len(self.instrs) + len(words) > MAX_INSTR:
            raise ProgramTooLarge(f"more than {MAX_INSTR} instruction words")
        self.instrs.extend(words)

    def emit(self, op: int, dst: int, a: int = 0, b: int = 0) -> int:
        self._words(op | (dst << 8) | (a << 16) | (b << 24))
        return dst

    def load(self, plane: int) -> int:
        return self.emit(OP_LOAD, self.reg(), plane)

    def const(self, ones: bool) -> int:
        return self.emit(OP_ONES if ones else OP_ZERO, self.reg())

    def op(self, op: int, a: int, b: int = 0, dst: Optional[int] = None
           ) -> int:
        """dst = a OP b (a fresh register when dst is None)."""
        return self.emit(op, self.reg() if dst is None else dst, a, b)

    def bsi(self, src: int, first: int, depth: int, mode: int, pred_bits,
            allow_eq: bool = False) -> int:
        """Register `src` walked in place by one OP_BSI (see encode_bsi)."""
        mask, info = encode_bsi(first, depth, mode, pred_bits, allow_eq,
                                self._max_planes)
        self._words(OP_BSI | (src << 8) | (src << 16), mask, info)
        return src

    def build(self, result: int) -> Program:
        instrs, result = compact_registers(self.instrs, result)
        return Program(instrs, list(self.planes), result, self.S, self.W)


def _reads(op: int, a: int, b: int) -> Tuple[int, ...]:
    """Registers an instruction reads."""
    if op in (OP_LOAD, OP_ZERO, OP_ONES):
        return ()
    if op in (OP_NOT, OP_BSI):
        return (a,)
    return (a, b)


def compact_registers(instrs: List[int], result: int
                      ) -> Tuple[List[int], int]:
    """Renumber registers to the fewest the program needs (a linear scan
    over exact liveness), so the kernel runs it with the smallest register
    file.  Fields an opcode does not read become 0.  A program that reads a
    register before writing it is returned as it is."""
    steps, k = [], 0
    while k < len(instrs):
        w = instrs[k]
        n = BSI_WORDS if w & 0xFF == OP_BSI else 1
        steps.append((w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, w >> 24,
                      instrs[k + 1:k + n]))
        k += n
    cur: Dict[int, int] = {}    # register -> defining step of its value
    last: Dict[int, int] = {}   # value -> last step that reads it
    for i, (op, d, a, b, _) in enumerate(steps):
        for r in _reads(op, a, b):
            if r not in cur:
                return list(instrs), result
            last[cur[r]] = i
        cur[d] = i
    if result not in cur:
        return list(instrs), result
    last[cur[result]] = len(steps)
    free: List[int] = []    # freed registers; fresh ones come after them
    fresh = 0
    phys: Dict[int, int] = {}
    cur = {}
    out: List[int] = []
    for i, (op, d, a, b, payload) in enumerate(steps):
        reads = _reads(op, a, b)
        new = [phys[cur[r]] for r in reads] + [0, 0]
        for v in {cur[r] for r in reads}:
            if last[v] == i:
                heapq.heappush(free, phys[v])
        if free:
            reg = heapq.heappop(free)
        else:
            reg, fresh = fresh, fresh + 1
        phys[i] = reg
        cur[d] = i
        if i not in last:           # a value nothing reads
            heapq.heappush(free, reg)
        na = a if op == OP_LOAD else new[0]
        out += [op | (reg << 8) | (na << 16) | (new[1] << 24), *payload]
    return out, phys[cur[result]]


def validate(prog: Program) -> None:
    """Raise ValueError unless the kernel's launcher would take `prog`
    (the same checks as valid_program in csrc/bitmap_kernels.cu)."""
    n, npl, ins = len(prog.instrs), len(prog.planes), prog.instrs
    if not 0 < n <= MAX_INSTR or not 0 < npl <= MAX_PLANES \
            or not 0 <= prog.result < NUM_REGS:
        raise ValueError(f"program of {n} words over {npl} planes with "
                         f"result register {prog.result} is out of bounds")
    if any(not 0 <= w < 1 << 32 for w in ins):
        raise ValueError("instruction words are uint32")
    k = 0
    while k < n:
        w = ins[k]
        op, d, a, b = w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, w >> 24
        bad = op > OP_BSI or d >= NUM_REGS
        if op == OP_LOAD:
            bad = bad or a >= npl or b != 0
        elif op == OP_BSI:
            bad = bad or k + 2 >= n or a >= NUM_REGS or b != 0
            if not bad:
                mask, info = ins[k + 1], ins[k + 2]
                first, depth = info & 0xFF, (info >> 8) & 0xFF
                bad = (info >> 20 != 0 or not 1 <= depth <= MAX_DEPTH
                       or (info >> 16) & 3 > MODE_GT or first + depth > npl
                       or mask >> depth != 0)
            k += 2
        else:
            bad = bad or a >= NUM_REGS or b >= NUM_REGS
        if bad:
            raise ValueError(f"bad instruction word {w:#010x} at {k}")
        k += 1


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words (SWAR in int32: every shift is
    masked, so the arithmetic shift reads as the logical one, and the first
    step wraps as the uint32 it stands for); returns int32 counts, whose
    sums torch takes in int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def bsi_walk_plain(b: torch.Tensor, planes: Sequence[torch.Tensor],
                   mask: int, info: int) -> torch.Tensor:
    """OP_BSI over whole tensors: the unsigned walk of ops/bsi_traced.py
    from the virtual plane `depth` down to plane 0."""
    first, depth, mode, bits, allow_eq = decode_bsi(mask, info)
    keep = torch.zeros_like(b)
    if bits[depth]:
        if mode == MODE_LT:
            keep = b
        b = torch.zeros_like(b)
    for i in range(depth - 1, -1, -1):
        s = planes[first + i]
        if mode == MODE_LT and bits[i]:
            keep = keep | (b & ~s)
        elif mode == MODE_GT and not bits[i]:
            keep = keep | (b & s)
        b = (b & s) if bits[i] else (b & ~s)
    if mode == MODE_EQ:
        return b
    return keep | b if allow_eq else keep


def plan_eval_plain(prog: Program, want_words: bool = True,
                    want_counts: bool = False
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Interpret `prog` with whole-tensor torch ops over (S, W)."""
    shape = (prog.S, prog.W)
    dev = prog.planes[0].device if prog.planes else torch.device("cpu")
    regs: List[Optional[torch.Tensor]] = [None] * (_FIELD_MAX + 1)
    k = 0
    while k < len(prog.instrs):
        ins = prog.instrs[k]
        op, d, a, b = ins & 0xFF, (ins >> 8) & 0xFF, (ins >> 16) & 0xFF, \
            ins >> 24
        if op == OP_LOAD:
            regs[d] = prog.planes[a]
        elif op == OP_ZERO:
            regs[d] = torch.zeros(shape, dtype=torch.int32, device=dev)
        elif op == OP_ONES:
            regs[d] = torch.full(shape, -1, dtype=torch.int32, device=dev)
        elif op == OP_AND:
            regs[d] = regs[a] & regs[b]
        elif op == OP_OR:
            regs[d] = regs[a] | regs[b]
        elif op == OP_XOR:
            regs[d] = regs[a] ^ regs[b]
        elif op == OP_ANDNOT:
            regs[d] = regs[a] & ~regs[b]
        elif op == OP_NOT:
            regs[d] = ~regs[a]
        elif op == OP_BSI:
            regs[d] = bsi_walk_plain(regs[a], prog.planes,
                                     prog.instrs[k + 1], prog.instrs[k + 2])
            k += 2
        else:
            raise ValueError(f"bad opcode {op}")
        k += 1
    res = regs[prog.result].contiguous()
    words = res if want_words else None
    counts = popcount_words(res).sum(-1) if want_counts else None
    return words, counts


def row_counts_plain(tile: torch.Tensor, filt: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(S, R, W) [& (S, W)] -> (S, R) int64 per-row popcounts."""
    x = tile if filt is None else tile & filt[:, None, :]
    return popcount_words(x).sum(-1)


def pair_counts_plain(masks: torch.Tensor, rows: torch.Tensor,
                      filt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(S, F, W) masks x (S, R, W) rows [& (S, W) filter] -> (F, R) int64:
    the set bits of each mask & row [& filter], summed over the shards,
    one mask at a time (the (S, F, R, W) intersections never exist)."""
    if filt is not None:
        masks = masks & filt[:, None, :]
    out = torch.empty((masks.shape[1], rows.shape[1]), dtype=torch.int64,
                      device=masks.device)
    for f in range(masks.shape[1]):
        out[f] = popcount_words(masks[:, f, None, :] & rows).sum((0, 2))
    return out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib(flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernels' library, built with extra nvcc `flags` if any."""
    from featurebase_tpu_torch.ops import build
    lib = build.load(SOURCE, flags)
    if not getattr(lib, "_fb_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fb_plan_eval.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), i32, i32, ctypes.POINTER(vp),
            ctypes.POINTER(i64), i32, i32, i64, vp, vp, vp, i64, vp, vp]
        lib.fb_plan_eval.restype = i32
        lib.fb_plan_eval_config.argtypes = [ctypes.POINTER(i32)] * 2
        lib.fb_plan_eval_config.restype = i32
        lib.fb_row_counts.argtypes = [vp, vp, ctypes.POINTER(i64), i32, i32,
                                      i32, i64, i32, vp, vp, vp, vp]
        lib.fb_row_counts.restype = i32
        lib.fb_row_counts_plan.argtypes = [i32, i32, i64, i32] + \
            [ctypes.POINTER(i32)] * 3
        lib.fb_row_counts_plan.restype = i32
        lib.fb_limits.argtypes = [ctypes.POINTER(i32)] * 5
        lib.fb_limits.restype = i32
        lim = [i32() for _ in range(5)]
        lib.fb_limits(*[ctypes.byref(x) for x in lim])
        if tuple(x.value for x in lim) != (MAX_INSTR, MAX_PLANES, NUM_REGS,
                                           MAX_DEPTH, CHUNK_QUANTUM):
            raise RuntimeError("kernel limits differ from cuda_kernels.py")
        lib._fb_typed = True
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _is_cpu(tensors: Sequence[torch.Tensor]) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) > 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


# plan_eval's and row_counts' completion ticket per (device, stream): zero
# between launches, since the last block of each launch resets it; launches
# on one stream run in order, so they never share it at once.
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(dev: torch.device, stream: int) -> torch.Tensor:
    t = _tickets.get((dev.index, stream))
    if t is None:
        t = _tickets[(dev.index, stream)] = torch.zeros(
            1, dtype=torch.int32, device=dev)
    return t


def plan_eval_config(device: Optional[torch.device] = None
                     ) -> Dict[str, int]:
    """The card's SMs and how many blocks of each form of kernel A one SM
    holds (the occupancy calculator's answer, which sizes the grid)."""
    sms, blocks = ctypes.c_int(), (ctypes.c_int * 8)()
    with torch.cuda.device(device or torch.device("cuda")):
        _check(_lib().fb_plan_eval_config(ctypes.byref(sms), blocks),
               "plan_eval_config")
    names = [f"staged_{r}x{v}" for r, v in ((2, 8), (2, 4), (4, 8), (4, 4),
                                            (NUM_REGS, 4))] \
        + [f"scalar_{r}" for r in (2, 4, NUM_REGS)]
    return {"sms": sms.value,
            "blocks_per_sm": dict(zip(names, (b for b in blocks)))}


def max_tiles(S: int, W: int) -> int:
    """Count slots that any launch over (S, W) may need."""
    return S * -(-W // CHUNK_QUANTUM)


def plan_eval(prog: Program, want_words: bool = True,
              want_counts: bool = False
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run a lowered plan: returns ((S, W) int32 words or None,
    (S,) int64 per-shard counts or None)."""
    S, W = prog.S, prog.W
    for p in prog.planes:
        if p.dtype != torch.int32 or p.dim() != 2 or tuple(p.shape) != (S, W) \
                or p.stride(1) != 1:
            raise ValueError(f"plane must be ({S}, {W}) int32 with unit word "
                             f"stride, got {tuple(p.shape)} {p.dtype} "
                             f"strides {p.stride()}")
    if not prog.planes:
        raise ValueError("a program needs at least one plane to place it")
    validate(prog)
    if _is_cpu(prog.planes):
        return plan_eval_plain(prog, want_words, want_counts)
    dev = prog.planes[0].device
    words = torch.empty((S, W), dtype=torch.int32, device=dev) \
        if want_words else None
    counts = partials = ticket = None
    n, npl = len(prog.instrs), len(prog.planes)
    instr = (ctypes.c_uint32 * n)(*prog.instrs)
    ptrs = (ctypes.c_void_p * npl)(*[p.data_ptr() for p in prog.planes])
    strides = (ctypes.c_longlong * npl)(*[p.stride(0) for p in prog.planes])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if want_counts:
            counts = torch.empty((S,), dtype=torch.int64, device=dev)
            partials = torch.empty((max_tiles(S, W),), dtype=torch.int64,
                                   device=dev)
            ticket = _ticket(dev, stream)
        rc = _lib().fb_plan_eval(
            instr, n, prog.result, ptrs, strides, npl, S, W,
            words.data_ptr() if words is not None else None,
            counts.data_ptr() if counts is not None else None,
            partials.data_ptr() if partials is not None else None,
            partials.numel() if partials is not None else 0,
            ticket.data_ptr() if ticket is not None else None, stream)
    _check(rc, "plan_eval")
    plan_eval.launches += 1
    return words, counts


plan_eval.launches = 0


# row_counts' accumulator per (device, stream): a count a row, zero between
# launches, since the last block of each launch copies its sums out and
# zeroes them (it grows, zeroed, when a launch needs more rows).
_row_accs: Dict[Tuple[int, int], torch.Tensor] = {}


def _row_acc(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _row_accs.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = _row_accs[(dev.index, stream)] = torch.zeros(
            max(n, 4096), dtype=torch.int32, device=dev)
    return t


def _row_launch(addrs: Optional[np.ndarray], faddrs: Optional[np.ndarray],
                W: int, dev: torch.device, S: int, R: int,
                affine: Optional[Sequence[int]] = None) -> torch.Tensor:
    """One launch of kernel B' over S x R rows: an (S, R) uint64 table of
    row addresses (0: an absent row) [and (S,) filter addresses, 0: a shard
    without a filter row], or for a stacked tile `affine` = (base, shard
    step, row step, filter base or 0, filter step) in bytes -> (S, R)
    int64.  The caller holds the tensors the addresses point into until
    this returns, when the launch is enqueued."""
    if S == 0 or R == 0 or W == 0:
        return torch.zeros((S, R), dtype=torch.int64, device=dev)
    filtered = faddrs is not None if affine is None else affine[3] != 0
    if affine is None:
        parts = [addrs.reshape(-1)] + ([] if faddrs is None
                                       else [faddrs.reshape(-1)])
        table = np.ascontiguousarray(np.concatenate(parts), dtype=np.uint64)
        aligned = not (table % np.uint64(16)).any()
    else:
        table = None
        aligned = not any(int(x) % 16 for x in affine)
    vec = 4 if W % 4 == 0 and aligned else 1
    lib = _lib()
    chunk, summed, inline = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    out = torch.empty((S, R), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _check(lib.fb_row_counts_plan(S, R, W, vec, ctypes.byref(chunk),
                                      ctypes.byref(summed),
                                      ctypes.byref(inline)), "row_counts")
        stream = torch.cuda.current_stream(dev).cuda_stream
        acc = ticket = dev_table = None
        if summed.value:
            acc = _row_acc(dev, stream, S * R)
            ticket = _ticket(dev, stream)
        if table is not None and table.size > inline.value:
            dev_table = torch.from_numpy(table.view(np.int64)).pin_memory() \
                .to(dev, non_blocking=True)
        rc = lib.fb_row_counts(
            table.ctypes.data if table is not None and dev_table is None
            else None,
            dev_table.data_ptr() if dev_table is not None else None,
            (ctypes.c_longlong * 5)(*affine) if affine is not None else None,
            S, R, int(filtered), W, vec, out.data_ptr(),
            acc.data_ptr() if acc is not None else None,
            ticket.data_ptr() if ticket is not None else None, stream)
    _check(rc, "row_counts")
    row_counts.launches += 1
    return out


def row_counts(tile: torch.Tensor, filt: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """(S, R, W) int32 tile [& (S, W) int32 filter] -> (S, R) int64: kernel
    B' with the tile's rows as an affine table, its base and strides (views
    with a unit word stride are taken as they are)."""
    if tile.dtype != torch.int32 or tile.dim() != 3:
        raise ValueError(f"tile must be (S, R, W) int32, got "
                         f"{tuple(tile.shape)} {tile.dtype}")
    S, R, W = tile.shape
    if filt is not None and (filt.dtype != torch.int32
                             or tuple(filt.shape) != (S, W)):
        raise ValueError(f"filter must be ({S}, {W}) int32, got "
                         f"{tuple(filt.shape)} {filt.dtype}")
    if _is_cpu([tile] if filt is None else [tile, filt]):
        return row_counts_plain(tile, filt)
    if tile.stride(2) != 1 or (filt is not None and filt.stride(1) != 1):
        raise ValueError("row_counts needs a unit word stride")
    affine = (tile.data_ptr(), tile.stride(0) * 4, tile.stride(1) * 4,
              0 if filt is None else filt.data_ptr(),
              0 if filt is None else filt.stride(0) * 4)
    return _row_launch(None, None, W, tile.device, S, R, affine)


row_counts.launches = 0


def row_counts_sharded(tiles, slots, filt=None) -> torch.Tensor:
    """Kernel B' over every shard in one launch, the rows read in place:
    tiles a list of per-shard (n_s, W) int32 tiles (a fragment's device
    mirror, or None for a shard without one), slots (S, R) int64 the slot of
    each row in its shard's tile (-1 absent), filt None, (S, W) words or
    per-shard (W,) words (None for a shard without a filter row) -> (S, R)
    int64, entry (s, r) the set bits of row r of shard s [& its filter]; 0
    for an absent row, and for every row of a shard whose filter row is
    None.  Counts as a row_counts launch."""
    S = len(tiles)
    sl = _slot_table(slots, S, "row")
    tensors = [t for t in tiles if t is not None]
    if filt is not None:
        tensors += [filt] if isinstance(filt, torch.Tensor) else \
            [f for f in filt if f is not None]
    if _all_cpu(tensors):
        return row_counts_sharded_plain(tiles, slots, filt)
    if all(t is None for t in tiles):
        return torch.zeros(sl.shape, dtype=torch.int64,
                           device=tensors[0].device)
    W = _words_per_row([t for t in tiles if t is not None]
                       + ([filt] if isinstance(filt, torch.Tensor) else []))
    dev = tensors[0].device
    return _row_launch(_dim_addrs(tiles, sl, W, "rows"),
                       None if filt is None
                       else _filter_addrs(filt, S, W)[:, 0], W, dev, S,
                       sl.shape[1])


def row_counts_sharded_plain(tiles, slots, filt=None) -> torch.Tensor:
    """row_counts_sharded shard by shard with torch ops."""
    S = len(tiles)
    sl = _slot_table(slots, S, "row")
    present = [t for t in tiles if t is not None]
    dev = _device_of(present)
    out = torch.zeros((S, sl.shape[1]), dtype=torch.int64, device=dev)
    if not present:
        return out
    W = _words_per_row(present)
    for s in range(S):
        rows = _gather_rows(tiles[s], sl[s], W, dev)
        f = _filter_row(filt, s, W, dev)
        out[s] = row_counts_plain(rows[None], None if f is None
                                  else f[None])[0]
    return out


def _bsi_lib() -> ctypes.CDLL:
    """The library of kernels C' and D', built on first use."""
    from featurebase_tpu_torch.ops import build
    from featurebase_tpu_torch.ops.bsi import MAX_DEPTH
    lib = build.load(BSI_SOURCE)
    if not getattr(lib, "_fb_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pi32, pi64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
        lib.fb_bsi_sum_planes.argtypes = [vp, vp, pi64, i32, i32, i64, i32,
                                          vp, vp, i64, vp, vp]
        lib.fb_bsi_min_max.argtypes = [vp, vp, pi64, i32, i32, i64, i32, i32,
                                       vp, vp, i64, vp, vp]
        lib.fb_bsi_scratch.argtypes = [i32, i32, i32, i64, i32, i32, pi64]
        lib.fb_bsi_limits.argtypes = [pi32] * 2
        for fn in (lib.fb_bsi_sum_planes, lib.fb_bsi_min_max,
                   lib.fb_bsi_scratch, lib.fb_bsi_limits):
            fn.restype = i32
        depth, inline = i32(), i32()
        lib.fb_bsi_limits(ctypes.byref(depth), ctypes.byref(inline))
        if depth.value != MAX_DEPTH:
            raise RuntimeError("kernel depth limit differs from ops/bsi.py")
        lib._fb_inline = inline.value
        lib._fb_typed = True
    return lib


def _bsi_inputs(group: torch.Tensor, filt: torch.Tensor) -> bool:
    """Check a stacked group and its filter; True when both lie on the
    CPU."""
    from featurebase_tpu_torch.ops.bsi import MAX_DEPTH
    if group.dtype != torch.int32 or group.dim() != 3 \
            or not 3 <= group.shape[1] <= MAX_DEPTH + 2 \
            or group.shape[0] == 0 or group.shape[2] == 0:
        raise ValueError(f"group must be (S, D + 2, W) int32 with 1 <= D <= "
                         f"{MAX_DEPTH}, got {tuple(group.shape)} {group.dtype}")
    S, _, W = group.shape
    if filt.dtype != torch.int32 or tuple(filt.shape) != (S, W):
        raise ValueError(f"filter must be ({S}, {W}) int32, got "
                         f"{tuple(filt.shape)} {filt.dtype}")
    if _is_cpu([group, filt]):
        return True
    if group.stride(2) != 1 or filt.stride(1) != 1:
        raise ValueError("the BSI kernels need a unit word stride")
    return False


def _bsi_affine(group: torch.Tensor, filt: torch.Tensor) -> Tuple[int, ...]:
    """A stacked group's table: (base, shard step, plane step, filter base,
    filter step) in bytes."""
    return (group.data_ptr(), group.stride(0) * 4, group.stride(1) * 4,
            filt.data_ptr(), filt.stride(0) * 4)


# the counters of kernel C' per (device, stream): zero between launches, since
# the last block of each launch copies them out and zeroes them.
_bsi_accs: Dict[Tuple[int, int], torch.Tensor] = {}


def _bsi_acc(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _bsi_accs.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = _bsi_accs[(dev.index, stream)] = torch.zeros(
            max(n, 128), dtype=torch.int64, device=dev)
    return t


def _bsi_launch(kernel, addrs: Optional[np.ndarray],
                faddrs: Optional[np.ndarray], affine: Optional[Sequence[int]],
                S: int, D: int, W: int, dev: torch.device,
                is_min: bool = False) -> torch.Tensor:
    """One launch of kernel C' (`kernel` bsi_sum_planes) or D'
    (bsi_min_max) over S shards of D + 2 planes: an (S, D + 2) uint64
    table of plane addresses and (S, 1) filter addresses (0: absent), or
    for a stacked group `affine` (_bsi_affine) -> C' (2D + 1,) int64, D'
    (S, 4, 2) int64.  The caller holds the tensors the addresses point into
    until this returns, when the launch is enqueued."""
    lib = _bsi_lib()
    if affine is None:
        table = np.ascontiguousarray(np.concatenate(
            [addrs.reshape(-1), faddrs.reshape(-1)]), dtype=np.uint64)
        aligned = not (table % np.uint64(16)).any()
    else:
        table = None
        aligned = not any(int(x) % 16 for x in affine)
    vec = 4 if W % 4 == 0 and aligned else 1
    which = 0 if kernel is bsi_sum_planes else 1
    n = ctypes.c_longlong()
    with torch.cuda.device(dev):
        _check(lib.fb_bsi_scratch(which, S, D, W, vec, int(is_min),
                                  ctypes.byref(n)), kernel.__name__)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == 0:
            out = torch.empty(2 * D + 1, dtype=torch.int64, device=dev)
            scratch = _bsi_acc(dev, stream, n.value)
        else:
            out = torch.empty((S, 4, 2), dtype=torch.int64, device=dev)
            scratch = torch.empty(n.value, dtype=torch.int64, device=dev)
        dev_table = None
        if table is not None and table.size > lib._fb_inline:
            dev_table = torch.from_numpy(table.view(np.int64)).pin_memory() \
                .to(dev, non_blocking=True)
        args = (table.ctypes.data if table is not None and dev_table is None
                else None,
                dev_table.data_ptr() if dev_table is not None else None,
                (ctypes.c_longlong * 5)(*affine) if affine is not None
                else None, S, D, W, vec)
        tail = (out.data_ptr(), scratch.data_ptr(), scratch.numel(),
                _ticket(dev, stream).data_ptr(), stream)
        rc = lib.fb_bsi_sum_planes(*args, *tail) if which == 0 else \
            lib.fb_bsi_min_max(*args, int(is_min), *tail)
    _check(rc, kernel.__name__)
    kernel.launches += 1
    return out


def bsi_sum_planes(group: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Kernel C': an (S, D + 2, W) int32 group under an (S, W) int32 filter
    -> (2D + 1,) int64: each plane's set bits under the positive columns,
    then under the negative columns, then the count of the columns.  The
    group is an affine table (views with a unit word stride are taken as
    they are)."""
    if _bsi_inputs(group, filt):
        from featurebase_tpu_torch.ops.bsi import sum_planes_plain
        return sum_planes_plain(group, filt)
    S, P, W = group.shape
    return _bsi_launch(bsi_sum_planes, None, None, _bsi_affine(group, filt),
                       S, P - 2, W, group.device)


bsi_sum_planes.launches = 0


def bsi_min_max(group: torch.Tensor, filt: torch.Tensor, is_min: bool
                ) -> torch.Tensor:
    """Kernel D': an (S, D + 2, W) int32 group under an (S, W) int32 filter
    -> (S, 4, 2) int64: per shard the descents pos-min, pos-max, neg-min,
    neg-max, each as (magnitude, count of the columns at it); a Min
    (is_min) runs pos-min and neg-max, a Max pos-max and neg-min, and the
    other two are (0, 0)."""
    if _bsi_inputs(group, filt):
        from featurebase_tpu_torch.ops.bsi import min_max_parts_plain
        return min_max_parts_plain(group, filt, is_min)
    S, P, W = group.shape
    return _bsi_launch(bsi_min_max, None, None, _bsi_affine(group, filt), S,
                       P - 2, W, group.device, is_min)


bsi_min_max.launches = 0


def _bsi_groups(groups, max_depth: int):
    """Per-shard BSI groups -> (tiles, (S, D + 2) slots, D).  A group is
    None (a shard without data), a (D + 2, W) tensor, or a (tile, slots)
    pair: the slot of each plane in a fragment's device mirror, -1 for an
    absent plane.  Every group has the same depth, 1 <= D <= max_depth."""
    tiles, slots = [], []
    for g in groups:
        if g is None:
            tiles.append(None)
            slots.append(None)
        elif isinstance(g, torch.Tensor):
            _words(g, "BSI group", 2)
            tiles.append(g)
            slots.append(np.arange(g.shape[0], dtype=np.int64))
        else:
            sl = np.asarray(g[1], dtype=np.int64).reshape(-1)
            if sl.size and (sl.min() < -1 or sl.max() >= g[0].shape[0]):
                raise ValueError("BSI group: a slot past its tile")
            tiles.append(g[0])
            slots.append(sl)
    Ps = {len(sl) for sl in slots if sl is not None}
    if len(Ps) > 1 or (Ps and not 3 <= min(Ps) <= max_depth + 2):
        raise ValueError(f"BSI groups must share one depth D + 2 planes with "
                         f"1 <= D <= {max_depth}, got {sorted(Ps)}")
    P = Ps.pop() if Ps else 3
    sl = np.stack([np.full(P, -1, dtype=np.int64) if s is None else s
                   for s in slots]) if slots else np.zeros((0, P), np.int64)
    return tiles, sl, P - 2


def _bsi_group_inputs(groups, filt):
    """Check per-shard BSI groups (_bsi_groups) and their filter ->
    (tiles, (S, D + 2) slots, D, W, every tensor)."""
    from featurebase_tpu_torch.ops.bsi import MAX_DEPTH
    tiles, sl, D = _bsi_groups(groups, MAX_DEPTH)
    if filt is None:
        raise ValueError("the BSI kernels need a filter")
    rows = [filt] if isinstance(filt, torch.Tensor) else \
        [f for f in filt if f is not None]
    tensors = [t for t in tiles if t is not None] + rows
    W = _words_per_row(tensors) if tensors else 1
    return tiles, sl, D, W, tensors


def bsi_sum_planes_sharded_plain(groups, filt) -> torch.Tensor:
    """bsi_sum_planes_sharded shard by shard with torch ops."""
    from featurebase_tpu_torch.ops.bsi import sum_planes_plain
    tiles, sl, D, W, tensors = _bsi_group_inputs(groups, filt)
    dev = _device_of(tensors)
    out = torch.zeros(2 * D + 1, dtype=torch.int64, device=dev)
    for s, tile in enumerate(tiles):
        if tile is not None:
            out += sum_planes_plain(_gather_rows(tile, sl[s], W, dev)[None],
                                    _filter_row(filt, s, W, dev)[None])
    return out


def bsi_min_max_sharded_plain(groups, filt, is_min: bool) -> torch.Tensor:
    """bsi_min_max_sharded shard by shard with torch ops."""
    from featurebase_tpu_torch.ops.bsi import min_max_parts_plain
    tiles, sl, D, W, tensors = _bsi_group_inputs(groups, filt)
    dev = _device_of(tensors)
    out = torch.zeros((len(tiles), 4, 2), dtype=torch.int64, device=dev)
    for s, tile in enumerate(tiles):
        if tile is not None:
            out[s] = min_max_parts_plain(
                _gather_rows(tile, sl[s], W, dev)[None],
                _filter_row(filt, s, W, dev)[None], is_min)[0]
    return out


def bsi_sum_planes_sharded(groups, filt) -> torch.Tensor:
    """Kernel C' over every shard in one launch, the planes read in place:
    groups a list of per-shard BSI groups (None for a shard without data,
    a (D + 2, W) int32 tensor or view, or a (tile, slots) pair naming each
    plane's row of a fragment's device mirror, -1 absent), filt (S, W)
    words or per-shard (W,) words (None for a shard without a filter row)
    -> (2D + 1,) int64 as bsi_sum_planes gives, over every shard.  An absent
    plane reads as zeros; a shard without its exists plane or filter row
    adds nothing.  Counts as a bsi_sum_planes launch."""
    tiles, sl, D, W, tensors = _bsi_group_inputs(groups, filt)
    if _all_cpu(tensors):
        return bsi_sum_planes_sharded_plain(groups, filt)
    dev = tensors[0].device
    addrs = _dim_addrs(tiles, sl, W, "BSI group")
    faddrs = _filter_addrs(filt, len(tiles), W)
    live = (addrs[:, 0] != 0) & (faddrs[:, 0] != 0)
    if not live.any():
        return torch.zeros(2 * D + 1, dtype=torch.int64, device=dev)
    return _bsi_launch(bsi_sum_planes, addrs[live], faddrs[live], None,
                       int(live.sum()), D, W, dev)


def bsi_min_max_sharded(groups, filt, is_min: bool) -> torch.Tensor:
    """Kernel D' over every shard in one launch, the planes read in place:
    groups and filt as bsi_sum_planes_sharded takes them -> (S, 4, 2) int64
    as bsi_min_max gives, a shard without columns (0, 0) in every entry.
    Counts as a bsi_min_max launch."""
    tiles, sl, D, W, tensors = _bsi_group_inputs(groups, filt)
    if _all_cpu(tensors):
        return bsi_min_max_sharded_plain(groups, filt, is_min)
    dev = tensors[0].device
    if not tiles:
        return torch.zeros((0, 4, 2), dtype=torch.int64, device=dev)
    return _bsi_launch(bsi_min_max, _dim_addrs(tiles, sl, W, "BSI group"),
                       _filter_addrs(filt, len(tiles), W), None, len(tiles),
                       D, W, dev, is_min)


def _group_lib(flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Kernels E and F's library, built on first use (with extra nvcc
    `flags` if any)."""
    from featurebase_tpu_torch.ops import build
    from featurebase_tpu_torch.ops.bsi import MAX_DEPTH
    lib = build.load(GROUP_SOURCE, flags)
    if not getattr(lib, "_fb_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pi64, pi32 = ctypes.POINTER(i64), ctypes.POINTER(i32)
        lib.fb_group_product_slots.argtypes = [pi32, i64, pi64, pi32, pi32]
        lib.fb_group_product.argtypes = [pi32, i64, vp, vp, vp, i64, vp, i32,
                                         vp]
        lib.fb_popc_rate.argtypes = [vp, i32, i32, vp]
        lib.fb_tc_rate.argtypes = [vp, i32, i32, i32, vp]
        lib.fb_group_limits.argtypes = [pi32, pi32]
        for fn in (lib.fb_group_product_slots, lib.fb_group_product,
                   lib.fb_popc_rate, lib.fb_tc_rate, lib.fb_group_limits):
            fn.restype = i32
        depth, spec = i32(), i32()
        lib.fb_group_limits(ctypes.byref(depth), ctypes.byref(spec))
        if depth.value != MAX_DEPTH or spec.value != _SPEC_WORDS:
            raise RuntimeError("kernel limits differ from cuda_kernels.py")
        lib._fb_typed = True
    return lib


# The group product's modes (csrc/group_kernels.cu): kernel E multiplies A
# by rows, kernel F by a BSI group's classes.
MODE_ROWS, MODE_BSI = 0, 1
_SPEC_WORDS = 15

# kernels E and F's tickets per (device, stream), one an output region: zero
# between launches, since the last block of each region resets its own.
_run_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket_array(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    t = _run_tickets.get((dev.index, stream))
    if t is None or t.numel() < n:
        t = _run_tickets[(dev.index, stream)] = torch.zeros(
            max(n, 1024), dtype=torch.int32, device=dev)
    return t


def _words(t: torch.Tensor, what: str, dims: int) -> None:
    if t.dtype != torch.int32 or t.dim() != dims:
        raise ValueError(f"{what} must be {dims}-D int32, got "
                         f"{tuple(t.shape)} {t.dtype}")


# -- the operands: per-shard tiles and slot tables ---------------------------

def _check_tile(t: torch.Tensor, W: int, what: str) -> None:
    _words(t, what, 2)
    if t.shape[1] != W or t.stride(1) != 1:
        raise ValueError(f"{what} must be (n, {W}) with unit word stride, got "
                         f"{tuple(t.shape)} strides {t.stride()}")


def _slot_table(slots, S: int, what: str) -> np.ndarray:
    s = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots,
                   dtype=np.int64)
    if s.ndim != 2 or s.shape[0] != S:
        raise ValueError(f"{what} slots must be ({S}, n), got {s.shape}")
    return s


def _dim_addrs(tiles: Sequence[Optional[torch.Tensor]], slots: np.ndarray,
               W: int, what: str) -> np.ndarray:
    """(S, n) uint64 row addresses of one dimension: tile s's row at
    slots[s, i], 0 for slot -1 or a shard without a tile."""
    S = slots.shape[0]
    if len(tiles) != S:
        raise ValueError(f"{what}: {len(tiles)} tiles for {S} shards")
    base = np.zeros(S, dtype=np.uint64)
    step = np.zeros(S, dtype=np.uint64)
    rows = np.zeros(S, dtype=np.int64)
    for s, t in enumerate(tiles):
        if t is not None:
            _check_tile(t, W, what)
            base[s], step[s], rows[s] = t.data_ptr(), t.stride(0) * 4, \
                t.shape[0]
    if ((slots >= rows[:, None]) & (base[:, None] != 0)).any() \
            or (slots < -1).any():
        raise ValueError(f"{what}: a slot past its tile")
    live = (slots >= 0) & (base[:, None] != 0)
    return np.where(live, base[:, None]
                    + np.maximum(slots, 0).astype(np.uint64) * step[:, None],
                    np.uint64(0))


def _stacked_addrs(t: torch.Tensor) -> np.ndarray:
    """(S, n) uint64 addresses of the rows of a stacked (S, n, W) tensor."""
    S, n, _ = t.shape
    s = np.arange(S, dtype=np.uint64)[:, None] * np.uint64(t.stride(0) * 4)
    r = np.arange(n, dtype=np.uint64)[None, :] * np.uint64(t.stride(1) * 4)
    return np.uint64(t.data_ptr()) + s + r


def _filter_addrs(filt, S: int, W: int) -> np.ndarray:
    """(S, 1) addresses of the filter: (S, W) words or per-shard (W,)."""
    if isinstance(filt, torch.Tensor):
        _words(filt, "filter", 2)
        if tuple(filt.shape) != (S, W) or filt.stride(1) != 1:
            raise ValueError(f"filter must be ({S}, {W}), got "
                             f"{tuple(filt.shape)}")
        return _stacked_addrs(filt[:, None, :])[:, :1]
    if len(filt) != S:
        raise ValueError(f"{len(filt)} filter rows for {S} shards")
    out = np.zeros((S, 1), dtype=np.uint64)
    for s, f in enumerate(filt):
        if f is not None:
            _check_tile(f[None], W, "filter")
            out[s, 0] = f.data_ptr()
    return out


def _product(mode: int, dims: List[np.ndarray], filt: Optional[np.ndarray],
             b: np.ndarray, NB: int, D: int, W: int,
             dev: torch.device) -> torch.Tensor:
    """One launch of kernel E (MODE_ROWS) or F (MODE_BSI) over the address
    tables: dims (S, n_d) each, the filter (S, 1) or None, and B (S, NB rows
    or D + 2 planes) -> (prod n_d, NB) int64.  Shards whose rows are all
    absent in some dimension or in B are left out of the table.  The
    caller holds the tensors the addresses point into until this returns,
    when the launch is enqueued."""
    GA = int(np.prod([d.shape[1] for d in dims]))
    out = torch.zeros((GA, NB), dtype=torch.int64, device=dev)
    live = np.ones(b.shape[0], dtype=bool)
    for a in (*dims, b[:, :1] if mode == MODE_BSI else b):
        live &= (a != 0).any(1)
    if filt is not None:
        live &= filt[:, 0] != 0
    if GA == 0 or not live.any():
        return out
    cols = [*dims, *([] if filt is None else [filt]), b]
    table = np.ascontiguousarray(np.concatenate(cols, axis=1)[live])
    S, P = table.shape
    vec = 4 if W % 4 == 0 and not (table % np.uint64(16)).any() else 1
    col0 = np.cumsum([0] + [d.shape[1] for d in dims])
    spec = [mode, vec, S, P, len(dims)] \
        + [d.shape[1] for d in dims] + [1] * (3 - len(dims)) \
        + [int(c) for c in col0[:len(dims)]] + [0] * (3 - len(dims)) \
        + [-1 if filt is None else int(col0[-1]),
           int(col0[-1]) + (filt is not None), NB, D]
    spec_c = (ctypes.c_int * _SPEC_WORDS)(*spec)
    lib = _group_lib()
    n, runs, cw = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(dev):
        _check(lib.fb_group_product_slots(spec_c, W, ctypes.byref(n),
                                          ctypes.byref(runs),
                                          ctypes.byref(cw)), "group product")
        host = torch.from_numpy(table.view(np.int64)).pin_memory()
        dev_table = host.to(dev, non_blocking=True)
        slots = torch.empty(n.value, dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _ticket_array(dev, stream, runs.value)
        rc = lib.fb_group_product(spec_c, W, dev_table.data_ptr(),
                                  out.data_ptr(), slots.data_ptr(),
                                  slots.numel(), tickets.data_ptr(),
                                  tickets.numel(), stream)
    kernel = pair_counts if mode == MODE_ROWS else bsi_sum_groups
    _check(rc, kernel.__name__)
    kernel.launches += 1
    return out


def _all_cpu(tensors: List[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU (or there is none)."""
    return _is_cpu(tensors) if tensors else True


# -- plain versions of the sharded product -----------------------------------

def _gather_rows(tile: Optional[torch.Tensor], slots: np.ndarray, W: int,
                 dev) -> torch.Tensor:
    """(n, W) rows of a tile at `slots`, zeros for -1 or no tile."""
    out = torch.zeros((len(slots), W), dtype=torch.int32, device=dev)
    if tile is not None:
        for i, sl in enumerate(slots):
            if sl >= 0:
                out[i] = tile[int(sl)]
    return out


def _group_masks_plain(dims, s: int, filt_row, W: int, dev) -> torch.Tensor:
    """(prod n_d, W) masks of shard s: f_i [& g_j [& h_k]] [& filter], the
    last dimension fastest."""
    m = None
    for tiles, slots in dims:
        rows = _gather_rows(tiles[s], slots[s], W, dev)
        m = rows if m is None else \
            (m[:, None, :] & rows[None, :, :]).reshape(-1, W)
    if filt_row is not None:
        m = m & filt_row[None, :]
    return m


def _filter_row(filt, s: int, W: int, dev):
    if filt is None:
        return None
    row = filt[s]
    return torch.zeros(W, dtype=torch.int32, device=dev) if row is None \
        else row


def pair_counts_sharded_plain(mask_tiles, mask_slots, row_tiles, row_slots,
                              filt=None, mid=None) -> torch.Tensor:
    """pair_counts_sharded shard by shard with torch ops."""
    dims, rows, W, S = _sharded_inputs(mask_tiles, mask_slots, row_tiles,
                                       row_slots, mid)
    dev = _device_of([t for t in (*mask_tiles, *row_tiles) if t is not None])
    GA = int(np.prod([sl.shape[1] for _, sl in dims]))
    out = torch.zeros((GA, rows[1].shape[1]), dtype=torch.int64, device=dev)
    for s in range(S):
        m = _group_masks_plain(dims, s, _filter_row(filt, s, W, dev), W, dev)
        r = _gather_rows(rows[0][s], rows[1][s], W, dev)
        out += pair_counts_plain(m[None], r[None])
    return out


def bsi_sum_groups_sharded_plain(bsi_tiles, dims, filt=None) -> torch.Tensor:
    """bsi_sum_groups_sharded shard by shard with torch ops."""
    from featurebase_tpu_torch.ops.bsi import sum_groups_plain
    dims, D, W, S = _bsi_sharded_inputs(bsi_tiles, dims)
    dev = _device_of([t for t in bsi_tiles if t is not None])
    GA = int(np.prod([sl.shape[1] for _, sl in dims]))
    out = torch.zeros((GA, 2 * D + 1), dtype=torch.int64, device=dev)
    for s in range(S):
        if bsi_tiles[s] is None:
            continue
        m = _group_masks_plain(dims, s, _filter_row(filt, s, W, dev), W, dev)
        out += sum_groups_plain(bsi_tiles[s][None], m[None])
    return out


def _device_of(tensors: List[torch.Tensor]) -> torch.device:
    return tensors[0].device if tensors else torch.device("cpu")


def _sharded_inputs(mask_tiles, mask_slots, row_tiles, row_slots, mid):
    S = len(mask_tiles)
    W = _words_per_row([*mask_tiles, *row_tiles])
    dims = [(list(mask_tiles), _slot_table(mask_slots, S, "mask"))]
    if mid is not None:
        dims.append((list(mid[0]), _slot_table(mid[1], S, "mid")))
    rows = (list(row_tiles), _slot_table(row_slots, S, "row"))
    return dims, rows, W, S


def _bsi_sharded_inputs(bsi_tiles, dims):
    from featurebase_tpu_torch.ops.bsi import MAX_DEPTH
    S = len(bsi_tiles)
    if not 1 <= len(dims) <= 3:
        raise ValueError(f"1 to 3 dimensions, got {len(dims)}")
    present = [t for t in bsi_tiles if t is not None]
    W = _words_per_row(present + [t for tiles, _ in dims for t in tiles
                                  if t is not None])
    Ps = {t.shape[0] for t in present}
    if len(Ps) > 1 or (Ps and not 3 <= min(Ps) <= MAX_DEPTH + 2):
        raise ValueError(f"BSI tiles must share one (D + 2, W) shape with "
                         f"1 <= D <= {MAX_DEPTH}, got {sorted(Ps)}")
    D = (Ps.pop() if Ps else 3) - 2
    dims = [(list(t), _slot_table(sl, S, f"dimension {i}"))
            for i, (t, sl) in enumerate(dims)]
    return dims, D, W, S


def _words_per_row(tiles: List[Optional[torch.Tensor]]) -> int:
    Ws = {t.shape[-1] for t in tiles if t is not None}
    if len(Ws) != 1:
        raise ValueError(f"tiles must share one row width, got {sorted(Ws)}")
    return Ws.pop()


# -- kernels E and F ---------------------------------------------------------

def pair_counts_sharded(mask_tiles, mask_slots, row_tiles, row_slots,
                        filt=None, mid=None) -> torch.Tensor:
    """Kernel E over every shard in one launch, its operands read in place:
    mask_tiles and row_tiles are lists of per-shard (n_s, W) int32 tiles
    (a fragment's device mirror, or None for a shard without one),
    mask_slots (S, F) and row_slots (S, R) int64 the slot of each mask and
    row in its shard's tile (-1 absent); `mid`, an optional (tiles, slots)
    pair of a middle dimension (masks f_i & h_j, j fastest); filt (S, W)
    words or per-shard (W,) words -> (F [x M], R) int64, entry (f, r) the
    set bits of mask f & row r [& filter] over every shard."""
    dims, rows, W, S = _sharded_inputs(mask_tiles, mask_slots, row_tiles,
                                       row_slots, mid)
    tensors = [t for t in (*mask_tiles, *row_tiles,
                           *([] if mid is None else mid[0]))
               if t is not None]
    if filt is not None:
        tensors += [filt] if isinstance(filt, torch.Tensor) else \
            [f for f in filt if f is not None]
    if _all_cpu(tensors):
        return pair_counts_sharded_plain(mask_tiles, mask_slots, row_tiles,
                                         row_slots, filt, mid)
    addrs = [_dim_addrs(t, sl, W, "dimension") for t, sl in dims]
    out = _product(MODE_ROWS, addrs,
                   None if filt is None else _filter_addrs(filt, S, W),
                   _dim_addrs(rows[0], rows[1], W, "rows"),
                   rows[1].shape[1], 0, W, tensors[0].device)
    return out


def bsi_sum_groups_sharded(bsi_tiles, dims, filt=None) -> torch.Tensor:
    """Kernel F over every shard in one launch: bsi_tiles a list of
    per-shard (D + 2, W) int32 groups (None for a shard without data), dims
    1 to 3 (tiles, slots) pairs as pair_counts_sharded takes them, filt
    (S, W) or per-shard (W,) words -> (G, 2D + 1) int64, G the product of
    the dimension sizes in itertools.product order (the last fastest): per
    group kernel C's counters with the group's mask [& filter] as the
    filter.  The group masks are formed on the card and never stored."""
    sdims, D, W, S = _bsi_sharded_inputs(bsi_tiles, dims)
    tensors = [t for t in bsi_tiles if t is not None] + \
        [t for tiles, _ in sdims for t in tiles if t is not None]
    if filt is not None:
        tensors += [filt] if isinstance(filt, torch.Tensor) else \
            [f for f in filt if f is not None]
    if _all_cpu(tensors):
        return bsi_sum_groups_sharded_plain(bsi_tiles, dims, filt)
    addrs = [_dim_addrs(t, sl, W, "dimension") for t, sl in sdims]
    planes = np.tile(np.arange(D + 2, dtype=np.int64), (S, 1))
    out = _product(MODE_BSI, addrs,
                   None if filt is None else _filter_addrs(filt, S, W),
                   _dim_addrs(bsi_tiles, planes, W, "BSI group"),
                   2 * D + 1, D, W, tensors[0].device)
    return out


def pair_counts(masks: torch.Tensor, rows: torch.Tensor,
                filt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel E over stacked operands: (S, F, W) int32 masks x (S, R, W)
    int32 rows [& (S, W) int32 filter] -> (F, R) int64, entry (f, r) the set
    bits of masks[s, f] & rows[s, r] [& filt[s]] summed over s.  The same
    launch as pair_counts_sharded, its table pointing into the stacked
    tensors (views with a unit word stride are taken as they are)."""
    _words(masks, "masks", 3)
    _words(rows, "rows", 3)
    S, F, W = masks.shape
    R = rows.shape[1]
    if rows.shape[0] != S or rows.shape[2] != W:
        raise ValueError(f"rows {tuple(rows.shape)} do not match masks "
                         f"{tuple(masks.shape)}")
    if filt is not None:
        _words(filt, "filter", 2)
        if tuple(filt.shape) != (S, W):
            raise ValueError(f"filter must be ({S}, {W}), got "
                             f"{tuple(filt.shape)}")
    if _is_cpu([masks, rows] + ([] if filt is None else [filt])):
        return pair_counts_plain(masks, rows, filt)
    if any(t.stride(-1) != 1 for t in (masks, rows, filt) if t is not None):
        raise ValueError("pair_counts needs a unit word stride")
    if S == 0 or F == 0 or R == 0 or W == 0:
        return torch.zeros((F, R), dtype=torch.int64, device=masks.device)
    out = _product(MODE_ROWS, [_stacked_addrs(masks)],
                   None if filt is None else _filter_addrs(filt, S, W),
                   _stacked_addrs(rows), R, 0, W, masks.device)
    return out


pair_counts.launches = 0


def bsi_sum_groups(group: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Kernel F over stacked operands: an (S, D + 2, W) int32 group x
    (S, G, W) int32 masks -> (G, 2D + 1) int64: per mask, kernel C's
    counters with the mask as the filter (each plane's set bits under the
    positive columns, then under the negative columns, then the count of the
    columns).  The same launch as bsi_sum_groups_sharded with the masks as
    its one dimension."""
    from featurebase_tpu_torch.ops.bsi import MAX_DEPTH
    _words(group, "group", 3)
    _words(masks, "masks", 3)
    S, P, W = group.shape
    G = masks.shape[1]
    if not 3 <= P <= MAX_DEPTH + 2:
        raise ValueError(f"group must have 1 to {MAX_DEPTH} magnitude planes, "
                         f"got {tuple(group.shape)}")
    if masks.shape[0] != S or masks.shape[2] != W:
        raise ValueError(f"masks {tuple(masks.shape)} do not match the group "
                         f"{tuple(group.shape)}")
    if _is_cpu([group, masks]):
        from featurebase_tpu_torch.ops.bsi import sum_groups_plain
        return sum_groups_plain(group, masks)
    if group.stride(-1) != 1 or masks.stride(-1) != 1:
        raise ValueError("bsi_sum_groups needs a unit word stride")
    D = P - 2
    if S == 0 or G == 0 or W == 0:
        return torch.zeros((G, 2 * D + 1), dtype=torch.int64,
                           device=group.device)
    out = _product(MODE_BSI, [_stacked_addrs(masks)], None,
                   _stacked_addrs(group), 2 * D + 1, D, W, group.device)
    return out


bsi_sum_groups.launches = 0


# -- kernel H': the moments of Var and Corr (csrc/moments_kernels.cu) --------

_MOMENTS_SPEC_WORDS = 9


def _moments_lib(flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library of kernel H', built on first use (with extra nvcc
    `flags` if any)."""
    from featurebase_tpu_torch.ops import build
    from featurebase_tpu_torch.ops.bsi import MAX_MOMENTS_DEPTH
    lib = build.load(MOMENTS_SOURCE, flags)
    if not getattr(lib, "_fb_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pi64, pi32 = ctypes.POINTER(i64), ctypes.POINTER(i32)
        lib.fb_moments_limits.argtypes = [pi32, pi32]
        lib.fb_moments_plan.argtypes = [pi32, i64, pi64]
        lib.fb_moments.argtypes = [pi32, i64, vp, vp, i64, vp]
        for fn in (lib.fb_moments_limits, lib.fb_moments_plan,
                   lib.fb_moments):
            fn.restype = i32
        depth, spec = i32(), i32()
        lib.fb_moments_limits(ctypes.byref(depth), ctypes.byref(spec))
        if depth.value != MAX_MOMENTS_DEPTH or \
                spec.value != _MOMENTS_SPEC_WORDS:
            raise RuntimeError("kernel limits differ from cuda_kernels.py")
        lib._fb_typed = True
    return lib


def moments_layout(depths: Sequence[int]) -> Dict[str, int]:
    """Where each class of the basis of kernel H' lies in its list L
    (csrc/moments_kernels.cu): the first class of each run and the output's
    rows R and columns C, whose column c is class c0 + c.  Var (one depth
    D): X_0.. at 0, P at D, Sx at D + 1.  Corr (Dx, Dy): Xs_0.. at 0; X_0..
    at c0 = 16 ceil(Dx / 16), then Y_0.., P and Sx; Sy at 16 (ceil(Dx / 16)
    + ceil((Dx + Dy + 2) / 16)) and Ys_0.. after it."""
    if len(depths) == 1:
        D = depths[0]
        return dict(X=0, P=D, Sx=D + 1, c0=0, R=D + 1, C=D + 2)
    Dx, Dy = depths
    gx, gm = -(-Dx // 16), -(-(Dx + Dy + 2) // 16)
    c0 = 16 * gx
    P, Sy = c0 + Dx + Dy, 16 * (gx + gm)
    return dict(Xs=0, X=c0, Y=c0 + Dx, P=P, Sx=P + 1, Sy=Sy, Ys=Sy + 1,
                c0=c0, R=P + 1, C=Sy + 1 + Dy - c0)


def _moments_spec(table: np.ndarray, W: int, depths: Sequence[int],
                  filtered: bool, cw: int = 0, stages: int = 0) -> List[int]:
    """The launch spec of kernel H' over an (S, P) address table: the
    filter's column first if `filtered`, then each group's D + 2 planes;
    cw and stages 0 leave the chunk words and the ring depth to the
    planner."""
    S, P = table.shape
    vec = 4 if W % 4 == 0 and not (table % np.uint64(16)).any() else 1
    return [vec, S, P, len(depths), depths[0],
            depths[1] if len(depths) == 2 else 0, int(filtered), cw, stages]


def moments_plan(spec: List[int], W: int) -> Dict[str, int]:
    """What the planner of kernel H' makes of a launch spec on the current
    device: the output's shape, form, chunk words, ring stages, staged rows
    a tile, resident blocks an SM, grid, shared bytes a block and the bytes
    the launch stages."""
    info = (ctypes.c_longlong * 10)()
    _check(_moments_lib().fb_moments_plan(
        (ctypes.c_int * _MOMENTS_SPEC_WORDS)(*spec), W, info), "moments plan")
    return dict(zip(("R", "C", "form", "chunk_words", "stages", "staged_rows",
                     "blocks_per_sm", "grid", "smem_bytes", "staged_bytes"),
                    info))


def _run_moments(kernel, spec: List[int], table: np.ndarray, W: int,
                 out: torch.Tensor) -> None:
    """Launch kernel H' of `spec` over the (S, P) uint64 address `table`
    into the zeroed `out`, and count the launch on `kernel`."""
    dev = out.device
    with torch.cuda.device(dev):
        plan = moments_plan(spec, W)
        if (plan["R"], plan["C"]) != tuple(out.shape):
            raise RuntimeError(f"kernel H' plans a {plan['R']} x {plan['C']} "
                               f"output, the layout {tuple(out.shape)}")
        host = torch.from_numpy(table.view(np.int64)).pin_memory()
        dev_table = host.to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _moments_lib().fb_moments(
            (ctypes.c_int * _MOMENTS_SPEC_WORDS)(*spec), W,
            dev_table.data_ptr(), out.data_ptr(), out.numel(), stream)
    _check(rc, kernel.__name__)
    kernel.launches += 1


def _moments_group(g: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """(S, D, W) of a stacked (S, D + 2, W) int32 group, 1 <= D <= 31."""
    from featurebase_tpu_torch.ops.bsi import MAX_MOMENTS_DEPTH
    if g.dtype != torch.int32 or g.dim() != 3 or \
            not 3 <= g.shape[1] <= MAX_MOMENTS_DEPTH + 2:
        raise ValueError(f"{what} must be (S, D + 2, W) int32 with 1 <= D <= "
                         f"{MAX_MOMENTS_DEPTH}, got {tuple(g.shape)} "
                         f"{g.dtype}")
    return g.shape[0], g.shape[1] - 2, g.shape[2]


def _moments_filter(filt: torch.Tensor, S: int, W: int) -> None:
    if filt.dtype != torch.int32 or tuple(filt.shape) != (S, W):
        raise ValueError(f"filter must be ({S}, {W}) int32, got "
                         f"{tuple(filt.shape)} {filt.dtype}")


def _moments_launch(kernel, groups: List[np.ndarray],
                    faddrs: Optional[np.ndarray], depths: List[int], W: int,
                    dev: torch.device) -> torch.Tensor:
    """One launch of kernel H' over address tables: one or two groups'
    (S, D + 2) plane addresses and the filter's (S, 1), or None for no
    filter (0: absent) -> the (R, C) int64 product of moments_layout.
    Shards whose exists planes or filter rows are absent add nothing and
    are left out.  The caller holds the tensors the addresses point into
    until this returns, when the launch is enqueued."""
    lay = moments_layout(depths)
    out = torch.zeros((lay["R"], lay["C"]), dtype=torch.int64, device=dev)
    live = np.ones(groups[0].shape[0], dtype=bool)
    for g in groups:
        live &= g[:, 0] != 0
    if faddrs is not None:
        live &= faddrs[:, 0] != 0
    if not live.any():
        return out
    table = np.ascontiguousarray(np.concatenate(
        ([] if faddrs is None else [faddrs]) + groups, axis=1)[live])
    _run_moments(kernel, _moments_spec(table, W, depths, faddrs is not None),
                 table, W, out)
    return out


def _var_parts(m: torch.Tensor, D: int):
    """var_moments_plain's (cnt, p, n, sq) from the Var product of kernel H':
    cnt = P.P, n = X.Sx, p = X.P - X.Sx, sq = X.X."""
    X, P, Sx = slice(0, D), D, D + 1
    n = m[X, Sx]
    return m[P, P], m[X, P] - n, n, m[X, X]


def _corr_parts(m: torch.Tensor, Dx: int, Dy: int):
    """corr_moments_plain's eleven outputs from the Corr product of kernel H':
    cnt = P.P; xn = X.Sx, xp = X.P - xn, and y's alike; sqx = X.X, sqy =
    Y.Y; with T = X.Y, A = Xs.Y, B = X.Ys and C = Xs.Ys the sign classes
    pp = T - A - B + C, pm = B - C, mp = A - C, mm = C."""
    lay = moments_layout([Dx, Dy])
    c0 = lay["c0"]

    def rows(k: str, n: int) -> slice:
        return slice(lay[k], lay[k] + n)

    def cols(k: str, n: int) -> slice:
        return slice(lay[k] - c0, lay[k] - c0 + n)
    P, Sx, Sy = lay["P"], lay["Sx"] - c0, lay["Sy"] - c0
    X, Y, Xs = rows("X", Dx), rows("Y", Dy), rows("Xs", Dx)
    xn, yn = m[X, Sx], m[Y, Sy]
    T, A = m[X, cols("Y", Dy)], m[Xs, cols("Y", Dy)]
    B, C = m[X, cols("Ys", Dy)], m[Xs, cols("Ys", Dy)]
    return (m[P, P - c0], m[X, P - c0] - xn, xn, m[Y, P - c0] - yn, yn,
            m[X, cols("X", Dx)], m[Y, cols("Y", Dy)], T - A - B + C, B - C,
            A - C, C)


def var_moments(group: torch.Tensor, filt: torch.Tensor):
    """Kernel H', Var form: an (S, D + 2, W) int32 group (1 <= D <= 31)
    under an (S, W) int32 filter -> (cnt, p (D,), n (D,), sq (D, D)) int64
    on the group's device, as var_moments_plain (ops/bsi.py) gives them.
    One launch, its table pointing into the stacked group (views with a
    unit word stride are taken as they are)."""
    S, D, W = _moments_group(group, "group")
    _moments_filter(filt, S, W)
    if _is_cpu([group, filt]):
        from featurebase_tpu_torch.ops.bsi import var_moments_plain
        return var_moments_plain(group, filt)
    if group.stride(2) != 1 or filt.stride(1) != 1:
        raise ValueError("var_moments needs a unit word stride")
    m = _moments_launch(var_moments, [_stacked_addrs(group)],
                        _filter_addrs(filt, S, W), [D], W, group.device)
    return _var_parts(m, D)


var_moments.launches = 0


def corr_moments(gx: torch.Tensor, gy: torch.Tensor, filt: torch.Tensor):
    """Kernel H', Corr form: two (S, D + 2, W) int32 groups (depths 1 to 31,
    each its own) under an (S, W) int32 filter -> corr_moments_plain's
    eleven int64 outputs on the groups' device.  One launch."""
    S, Dx, W = _moments_group(gx, "x group")
    Sy, Dy, Wy = _moments_group(gy, "y group")
    if (Sy, Wy) != (S, W):
        raise ValueError(f"y group {tuple(gy.shape)} does not match the x "
                         f"group {tuple(gx.shape)}")
    _moments_filter(filt, S, W)
    if _is_cpu([gx, gy, filt]):
        from featurebase_tpu_torch.ops.bsi import corr_moments_plain
        return corr_moments_plain(gx, gy, filt)
    if gx.stride(2) != 1 or gy.stride(2) != 1 or filt.stride(1) != 1:
        raise ValueError("corr_moments needs a unit word stride")
    m = _moments_launch(corr_moments, [_stacked_addrs(gx), _stacked_addrs(gy)],
                        _filter_addrs(filt, S, W), [Dx, Dy], W, gx.device)
    return _corr_parts(m, Dx, Dy)


corr_moments.launches = 0


def _moments_sharded_inputs(fields, filt):
    """Per-shard groups of one or two fields (_bsi_groups: None, a
    (D + 2, W) tensor or a (tile, slots) pair; 1 <= D <= 31) and a filter
    ((S, W) words, per-shard (W,) words or None rows, or None for no
    filter) -> ([(tiles, slots, D)], W, every tensor)."""
    from featurebase_tpu_torch.ops.bsi import MAX_MOMENTS_DEPTH
    parsed = [_bsi_groups(g, MAX_MOMENTS_DEPTH) for g in fields]
    S = len(fields[0])
    if any(len(g) != S for g in fields):
        raise ValueError("the fields' groups cover different shards")
    tensors = [t for tiles, _, _ in parsed for t in tiles if t is not None]
    if filt is not None:
        tensors += [filt] if isinstance(filt, torch.Tensor) else \
            [f for f in filt if f is not None]
    W = _words_per_row(tensors) if tensors else 1
    return parsed, W, tensors


def _moments_sharded_plain(parsed, filt, W: int, dev, plain):
    """A sharded moments wrapper's plain version: `plain` shard by shard
    over the gathered groups, summed."""
    parts = None
    for s in range(len(parsed[0][0])):
        if any(tiles[s] is None for tiles, _, _ in parsed):
            continue
        gs = [_gather_rows(tiles[s], sl[s], W, dev)[None]
              for tiles, sl, _ in parsed]
        f = torch.full((1, W), -1, dtype=torch.int32, device=dev) \
            if filt is None else _filter_row(filt, s, W, dev)[None]
        got = plain(*gs, f)
        parts = list(got) if parts is None else \
            [a + b for a, b in zip(parts, got)]
    if parts is None:   # no shard with data: zeros of the right shapes
        parts = plain(*[torch.zeros((1, D + 2, W), dtype=torch.int32,
                                    device=dev) for _, _, D in parsed],
                      torch.zeros((1, W), dtype=torch.int32, device=dev))
    return tuple(parts)


def var_moments_sharded(groups, filt=None):
    """Kernel H', Var form, over every shard in one launch, the planes read
    in place: groups as bsi_sum_planes_sharded takes them (depth 1 to 31),
    filt (S, W) words, per-shard (W,) words (None for a shard without a
    filter row) or None (no filter) -> var_moments' outputs over every
    shard.  Counts as a var_moments launch."""
    from featurebase_tpu_torch.ops.bsi import var_moments_plain
    parsed, W, tensors = _moments_sharded_inputs([groups], filt)
    dev = _device_of(tensors)
    if _all_cpu(tensors):
        return _moments_sharded_plain(parsed, filt, W, dev, var_moments_plain)
    tiles, sl, D = parsed[0]
    m = _moments_launch(
        var_moments, [_dim_addrs(tiles, sl, W, "BSI group")],
        None if filt is None else _filter_addrs(filt, len(tiles), W), [D],
        W, dev)
    return _var_parts(m, D)


def corr_moments_sharded(gx, gy, filt=None):
    """Kernel H', Corr form, over every shard in one launch: gx and gy the
    two fields' per-shard groups, filt as var_moments_sharded takes it ->
    corr_moments' outputs over every shard.  Counts as a corr_moments
    launch."""
    from featurebase_tpu_torch.ops.bsi import corr_moments_plain
    parsed, W, tensors = _moments_sharded_inputs([gx, gy], filt)
    dev = _device_of(tensors)
    if _all_cpu(tensors):
        return _moments_sharded_plain(parsed, filt, W, dev,
                                      corr_moments_plain)
    (tx, sx, Dx), (ty, sy, Dy) = parsed
    m = _moments_launch(
        corr_moments, [_dim_addrs(tx, sx, W, "x group"),
                       _dim_addrs(ty, sy, W, "y group")],
        None if filt is None else _filter_addrs(filt, len(tx), W), [Dx, Dy],
        W, dev)
    return _corr_parts(m, Dx, Dy)


# -- kernels G'', G''' and I': the decode family (csrc/decode_kernels.cu) ----

MAX_DECODE_DEPTH = 31      # int32 values; must match csrc/decode_kernels.cu
MAX_THRESHOLDS = 512


def _decode_lib(flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library of kernels G'', G''' and I', built on first use (with
    extra nvcc `flags` if any)."""
    from featurebase_tpu_torch.ops import build
    lib = build.load(DECODE_SOURCE, flags)
    if not getattr(lib, "_fb_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fb_bsi_decode.argtypes = [vp, ctypes.POINTER(i64), i32, i32, i64,
                                      i32, vp, vp]
        lib.fb_bsi_decode_gather.argtypes = [vp, i32, i32, vp, i64, vp, vp,
                                             vp, vp]
        lib.fb_percentile_counts.argtypes = [vp, i64, vp, i64, vp, i64, i32,
                                             i64, i32, vp, i32, vp, vp]
        lib.fb_decode_limits.argtypes = [ctypes.POINTER(i32)] * 3
        for fn in (lib.fb_bsi_decode, lib.fb_bsi_decode_gather,
                   lib.fb_percentile_counts, lib.fb_decode_limits):
            fn.restype = i32
        lim = [i32() for _ in range(3)]
        lib.fb_decode_limits(*[ctypes.byref(x) for x in lim])
        if (lim[0].value, lim[1].value) != (MAX_DECODE_DEPTH, MAX_THRESHOLDS):
            raise RuntimeError("kernel limits differ from cuda_kernels.py")
        lib._fb_item = lim[2].value
        lib._fb_typed = True
    return lib


def _group_planes(group: torch.Tensor, dims: int) -> Tuple[int, int]:
    """Check a BSI group of `dims` dimensions ((S, D + 2, W) or (D + 2, W))
    for the decode kernels: int32, 1 <= D <= MAX_DECODE_DEPTH, a unit word
    stride.  Returns (D, W)."""
    _words(group, "group", dims)
    P, W = group.shape[-2], group.shape[-1]
    if not 3 <= P <= MAX_DECODE_DEPTH + 2 or W == 0:
        raise ValueError(f"group must have 1 to {MAX_DECODE_DEPTH} magnitude "
                         f"planes, got {tuple(group.shape)}")
    if group.stride(-1) != 1:
        raise ValueError("the decode kernels need a unit word stride")
    return P - 2, W


def _decode_groups(groups):
    """Per-shard groups of the decode kernels (_bsi_groups, D <= 31) ->
    (tiles, (S, D + 2) slots, D, W, the tiles present); at least one shard
    must have data."""
    tiles, sl, D = _bsi_groups(groups, MAX_DECODE_DEPTH)
    tensors = [t for t in tiles if t is not None]
    if not tensors:
        raise ValueError("the decode kernels need a shard with data")
    return tiles, sl, D, _words_per_row(tensors), tensors


def _decode_launch(addrs: Optional[np.ndarray],
                   affine: Optional[Sequence[int]], S: int, D: int, W: int,
                   dev: torch.device) -> torch.Tensor:
    """One launch of kernel G'' over S shards of D + 2 planes: an
    (S, D + 2) uint64 table of plane addresses (0: absent), or for a
    stacked group `affine` = (base, shard step, plane step) in bytes ->
    (S, 32 W) int32.  The caller holds the tensors the addresses point into
    until this returns, when the launch is enqueued."""
    out = torch.empty((S, 32 * W), dtype=torch.int32, device=dev)
    if S == 0:
        return out
    lib = _decode_lib()
    if addrs is not None:
        table = np.ascontiguousarray(addrs.reshape(-1), dtype=np.uint64)
        aligned = not (table % np.uint64(16)).any()
    else:
        aligned = not any(int(x) % 16 for x in affine)
    vec = 4 if W % 4 == 0 and aligned else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        dev_table = None if addrs is None else torch.from_numpy(
            table.view(np.int64)).pin_memory().to(dev, non_blocking=True)
        rc = lib.fb_bsi_decode(
            None if dev_table is None else dev_table.data_ptr(),
            None if affine is None else (ctypes.c_longlong * 3)(*affine),
            S, D, W, vec, out.data_ptr(), stream)
    _check(rc, "bsi_decode")
    bsi_decode.launches += 1
    return out


def bsi_decode(group: torch.Tensor) -> torch.Tensor:
    """Kernel G'': an (S, D + 2, W) int32 group -> (S, 32 W) int32 values,
    unbased, negated where the sign bit is set; undefined (the decode of
    whatever bits are there) where exists is clear.  The group is an affine
    table (views with a unit word stride are taken as they are)."""
    D, W = _group_planes(group, 3)
    if _is_cpu([group]):
        from featurebase_tpu_torch.ops.decode import decode_values_plain
        return decode_values_plain(group)
    return _decode_launch(None, (group.data_ptr(), group.stride(0) * 4,
                                 group.stride(1) * 4),
                          group.shape[0], D, W, group.device)


bsi_decode.launches = 0


def bsi_decode_sharded(groups) -> torch.Tensor:
    """Kernel G'' over every shard in one launch, the planes read in place:
    groups a list of per-shard BSI groups (None for a shard without data, a
    (D + 2, W) int32 tensor or view, or a (tile, slots) pair naming each
    plane's row of a fragment's device mirror, -1 absent; D <= 31, at least
    one shard with data) -> (S, 32 W) int32 as bsi_decode gives, an absent
    plane read as zeros and a shard without data all zeros.  Counts as a
    bsi_decode launch."""
    tiles, sl, D, W, tensors = _decode_groups(groups)
    if _is_cpu(tensors):
        return bsi_decode_sharded_plain(groups)
    return _decode_launch(_dim_addrs(tiles, sl, W, "BSI group"), None,
                          len(tiles), D, W, tensors[0].device)


def bsi_decode_sharded_plain(groups) -> torch.Tensor:
    """bsi_decode_sharded shard by shard with torch ops."""
    from featurebase_tpu_torch.ops.decode import decode_values_plain
    tiles, sl, D, W, tensors = _decode_groups(groups)
    dev = tensors[0].device
    out = torch.zeros((len(tiles), 32 * W), dtype=torch.int32, device=dev)
    for s, tile in enumerate(tiles):
        if tile is not None:
            out[s] = decode_values_plain(_gather_rows(tile, sl[s], W, dev))
    return out


def _host_columns(cols_per_shard, S: int, W: int) -> List[np.ndarray]:
    """Each shard's in-shard column ids as int64 numpy, checked on the host
    to lie in [0, 32 W): numpy arrays or CPU tensors, never device tensors
    (their check would wait on the card)."""
    if len(cols_per_shard) != S:
        raise ValueError(f"{len(cols_per_shard)} column lists for {S} shards")
    out = []
    for c in cols_per_shard:
        if isinstance(c, torch.Tensor):
            if c.device.type != "cpu":
                raise ValueError("columns must be host ids (numpy or a CPU "
                                 "tensor)")
            c = c.numpy()
        a = np.asarray(c)
        if a.ndim != 1 or (a.size and a.dtype.kind not in "iu"):
            raise ValueError(f"columns must be (N,) integers, got {a.shape} "
                             f"{a.dtype}")
        out.append(a.astype(np.int64, copy=False))
    every = np.concatenate(out) if out else np.zeros(0, np.int64)
    if every.size and (every.min() < 0 or every.max() >= 32 * W):
        raise ValueError(f"columns must lie in [0, {32 * W})")
    return out


def bsi_decode_gather_sharded(groups, cols_per_shard
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel G''' over every shard in one launch, the planes read in
    place: groups as bsi_decode_sharded takes them, cols_per_shard a list of
    each shard's in-shard column ids (host arrays) -> (vals (N,) int32, ok
    (N,) int32) of every shard's columns in turn: each column's signed,
    unbased value and its exists bit, ok = 0 in a shard without data.  The
    columns are checked on the host and uploaded with the address table
    and the item table (at most 256 columns of one shard a block) in one
    pinned copy; no sync.  Counts as a bsi_decode_gather launch."""
    tiles, sl, D, W, tensors = _decode_groups(groups)
    cols = _host_columns(cols_per_shard, len(tiles), W)
    if _is_cpu(tensors):
        return bsi_decode_gather_sharded_plain(groups, cols)
    dev = tensors[0].device
    counts = np.array([c.size for c in cols], dtype=np.int64)
    N = int(counts.sum())
    vals = torch.empty(N, dtype=torch.int32, device=dev)
    ok = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return vals, ok
    if N >= 1 << 31:
        raise ValueError("at most 2^31 - 1 columns a launch")
    lib = _decode_lib()
    item = lib._fb_item
    per = -(-counts // item)
    shard = np.repeat(np.arange(len(cols)), per)
    first_item = np.concatenate([[0], np.cumsum(per)[:-1]])
    first_col = np.concatenate([[0], np.cumsum(counts)[:-1]])
    start = first_col[shard] + item * (np.arange(shard.size)
                                       - first_item[shard])
    n = np.minimum(item, first_col[shard] + counts[shard] - start)
    items = np.stack([shard, start, n], axis=1).astype(np.int32).reshape(-1)
    addrs = np.ascontiguousarray(_dim_addrs(tiles, sl, W, "BSI group"),
                                 dtype=np.uint64).reshape(-1)
    host = torch.from_numpy(np.concatenate(
        [addrs.view(np.int32), items,
         np.concatenate(cols).astype(np.int32)])).pin_memory()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        buf = host.to(dev, non_blocking=True)
        at = buf.data_ptr() + addrs.size * 8
        rc = lib.fb_bsi_decode_gather(
            buf.data_ptr(), len(tiles), D, at, shard.size,
            at + items.size * 4, vals.data_ptr(), ok.data_ptr(), stream)
    _check(rc, "bsi_decode_gather")
    bsi_decode_gather.launches += 1
    return vals, ok


def bsi_decode_gather_sharded_plain(groups, cols_per_shard
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bsi_decode_gather_sharded shard by shard with torch ops."""
    from featurebase_tpu_torch.ops.decode import decode_gather_plain
    tiles, sl, D, W, tensors = _decode_groups(groups)
    cols = _host_columns(cols_per_shard, len(tiles), W)
    dev = tensors[0].device
    parts = [decode_gather_plain(_gather_rows(tile, sl[s], W, dev),
                                 torch.from_numpy(c).to(dev))
             for s, (tile, c) in enumerate(zip(tiles, cols))]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([o for _, o in parts]))


def bsi_decode_gather(group: torch.Tensor, cols
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel G''' for one shard: a (D + 2, W) int32 group and (N,) host
    column ids (numpy or a CPU tensor) -> (vals (N,) int32, ok (N,)
    int32): each column's signed, unbased value and its exists bit."""
    D, W = _group_planes(group, 2)
    (c,) = _host_columns([cols], 1, W)
    if _is_cpu([group]):
        from featurebase_tpu_torch.ops.decode import decode_gather_plain
        return decode_gather_plain(group, torch.from_numpy(c))
    return bsi_decode_gather_sharded([group], [c])


bsi_decode_gather.launches = 0


def percentile_counts(vals: torch.Tensor, exists: torch.Tensor,
                      filt: torch.Tensor, base: int, thresholds
                      ) -> torch.Tensor:
    """Kernel I: over (S, 32 W) int32 values, with x = value + base (int32,
    wrapping) for each column whose bit is set in both the (S, W) exists and
    filter words, and K sorted thresholds (duplicates allowed) -> (2K + 3,)
    int64: the histogram of the 2K + 1 bins the thresholds make (bin 2k:
    t[k-1] < x < t[k]; bin 2k + 1: x == t[k], empty for a repeat of t[k-1]),
    then the min and the max of x (2^31 - 1 and -2^31 when no column is
    present).  K = 0 gives the count of the present columns in bin 0."""
    t = [int(x) for x in thresholds]
    if len(t) > MAX_THRESHOLDS or any(a > b for a, b in zip(t, t[1:])) \
            or any(not -(1 << 31) <= x < 1 << 31 for x in t):
        raise ValueError(f"thresholds must be at most {MAX_THRESHOLDS} sorted "
                         f"int32 values")
    if not -(1 << 31) <= int(base) < 1 << 31:
        raise ValueError("base must be an int32")
    _words(vals, "values", 2)
    _words(exists, "exists", 2)
    _words(filt, "filter", 2)
    S, W = exists.shape
    if tuple(filt.shape) != (S, W) or tuple(vals.shape) != (S, 32 * W):
        raise ValueError(f"values {tuple(vals.shape)}, exists "
                         f"{tuple(exists.shape)} and filter "
                         f"{tuple(filt.shape)} do not match")
    if _is_cpu([vals, exists, filt]):
        from featurebase_tpu_torch.ops.decode import percentile_counts_plain
        return percentile_counts_plain(vals, exists, filt, int(base), t)
    if any(x.stride(-1) != 1 for x in (vals, exists, filt)) \
            or vals.stride(0) % 4 or vals.data_ptr() % 16:
        raise ValueError("percentile_counts needs unit word strides and "
                         "16-byte aligned value rows")
    K, dev = len(t), vals.device
    init = torch.tensor([0] * (2 * K + 1) + [(1 << 31) - 1, -(1 << 31)]
                        + t, dtype=torch.int64).pin_memory()
    buf = init.to(dev, non_blocking=True)
    out, t_dev = buf[:2 * K + 3], buf[2 * K + 3:].to(torch.int32)
    if S == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _decode_lib().fb_percentile_counts(
            vals.data_ptr(), vals.stride(0), exists.data_ptr(),
            exists.stride(0), filt.data_ptr(), filt.stride(0), S, W,
            int(base), t_dev.data_ptr(), K, out.data_ptr(), stream)
    _check(rc, "percentile_counts")
    percentile_counts.launches += 1
    return out


percentile_counts.launches = 0

KERNELS = (plan_eval, row_counts, bsi_sum_planes, bsi_min_max, pair_counts,
           bsi_sum_groups, bsi_decode, bsi_decode_gather, percentile_counts,
           var_moments, corr_moments)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}
