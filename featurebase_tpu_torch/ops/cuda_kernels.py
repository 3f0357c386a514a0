"""Hopper kernels for the bitmap engine, with their plain PyTorch versions.

Counterpart of featurebase_tpu/ops/pallas_kernels.py.  The three Pallas
kernels there become two CUDA kernels (csrc/bitmap_kernels.cu, built by
ops/build.py and loaded with ctypes):

- ``plan_eval`` (kernel A) evaluates a lowered bitmap plan (a short register
  program over leaf planes, built with ``ProgramBuilder``) and writes the
  result words, per-shard counts, or both.  It replaces
  ``count_and_pallas`` (pallas_kernels.py:135-160): ``count_and`` is the
  program ``[load 0, load 1, and]``.  Bound: bytes — every leaf word is read
  once and, in count mode, nothing but S counts is written.
- ``row_counts`` (kernel B) gives per-row popcounts of an (S, R, W) tile,
  optionally ANDed with an (S, W) filter.  It replaces
  ``count_and_rows_pallas`` (:172-195) and ``popcount_rows_pallas``
  (:203-222).  Bound: bytes — the tile is read once, the filter once per
  row (mostly from L2).

Words are ``torch.int32`` tensors holding the uint32 bit patterns.  Each
wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches the kernel or raises.  ``launches`` on each wrapper counts
kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

SOURCE = "bitmap_kernels.cu"

# Program limits and opcodes; must match csrc/bitmap_kernels.cu.
MAX_INSTR = 640
MAX_PLANES = 48
NUM_REGS = 12

OP_LOAD, OP_ZERO, OP_ONES, OP_AND, OP_OR, OP_XOR, OP_ANDNOT, OP_NOT = range(8)


class ProgramTooLarge(Exception):
    """A plan needs more instructions, planes or registers than the kernel
    holds (MAX_INSTR / MAX_PLANES / NUM_REGS)."""


class Program:
    """A lowered plan: instructions over registers, the leaf planes they
    load ((S, W) int32 views, unit stride along W), and the result register."""

    __slots__ = ("instrs", "planes", "result", "S", "W")

    def __init__(self, instrs: List[int], planes: List[torch.Tensor],
                 result: int, S: int, W: int):
        self.instrs = instrs
        self.planes = planes
        self.result = result
        self.S = S
        self.W = W


class ProgramBuilder:
    """Emits a straight-line program with a free list of registers."""

    def __init__(self, S: int, W: int):
        self.S, self.W = S, W
        self.instrs: List[int] = []
        self.planes: List[torch.Tensor] = []
        self._plane_ids: Dict[object, int] = {}
        self._free = list(range(NUM_REGS - 1, -1, -1))

    def plane(self, key, tensor: torch.Tensor) -> int:
        """Index of a leaf plane, deduplicated by `key`."""
        pid = self._plane_ids.get(key)
        if pid is None:
            if len(self.planes) >= MAX_PLANES:
                raise ProgramTooLarge(f"more than {MAX_PLANES} planes")
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

    def emit(self, op: int, dst: int, a: int = 0, b: int = 0) -> int:
        if len(self.instrs) >= MAX_INSTR:
            raise ProgramTooLarge(f"more than {MAX_INSTR} instructions")
        self.instrs.append(op | (dst << 8) | (a << 16) | (b << 24))
        return dst

    def load(self, plane: int) -> int:
        return self.emit(OP_LOAD, self.reg(), plane)

    def const(self, ones: bool) -> int:
        return self.emit(OP_ONES if ones else OP_ZERO, self.reg())

    def op(self, op: int, a: int, b: int = 0, dst: Optional[int] = None
           ) -> int:
        """dst = a OP b (a fresh register when dst is None)."""
        return self.emit(op, self.reg() if dst is None else dst, a, b)

    def build(self, result: int) -> Program:
        return Program(list(self.instrs), list(self.planes), result,
                       self.S, self.W)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Elementwise popcount of int32 words (SWAR, in int64 so no step can
    overflow); returns int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def plan_eval_plain(prog: Program, want_words: bool = True,
                    want_counts: bool = False
                    ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Interpret `prog` with whole-tensor torch ops over (S, W)."""
    shape = (prog.S, prog.W)
    dev = prog.planes[0].device if prog.planes else torch.device("cpu")
    regs: List[Optional[torch.Tensor]] = [None] * NUM_REGS
    for ins in prog.instrs:
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
        else:
            raise ValueError(f"bad opcode {op}")
    res = regs[prog.result].contiguous()
    words = res if want_words else None
    counts = popcount_words(res).sum(-1) if want_counts else None
    return words, counts


def row_counts_plain(tile: torch.Tensor, filt: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(S, R, W) [& (S, W)] -> (S, R) int64 per-row popcounts."""
    x = tile if filt is None else tile & filt[:, None, :]
    return popcount_words(x).sum(-1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    from featurebase_tpu_torch.ops import build
    lib = build.load(SOURCE)
    if not getattr(lib, "_fb_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fb_plan_eval.argtypes = [
            ctypes.POINTER(ctypes.c_uint32), i32, i32, ctypes.POINTER(vp),
            ctypes.POINTER(i64), i32, i32, i64, vp, vp, vp]
        lib.fb_plan_eval.restype = i32
        lib.fb_row_counts.argtypes = [vp, vp, i32, i32, i64, vp, vp]
        lib.fb_row_counts.restype = i32
        lib.fb_limits.argtypes = [ctypes.POINTER(i32)] * 3
        lib.fb_limits.restype = i32
        lim = [i32(), i32(), i32()]
        lib.fb_limits(*[ctypes.byref(x) for x in lim])
        if tuple(x.value for x in lim) != (MAX_INSTR, MAX_PLANES, NUM_REGS):
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
    if _is_cpu(prog.planes):
        return plan_eval_plain(prog, want_words, want_counts)
    dev = prog.planes[0].device
    words = torch.empty((S, W), dtype=torch.int32, device=dev) \
        if want_words else None
    counts = torch.empty((S,), dtype=torch.int64, device=dev) \
        if want_counts else None
    n, npl = len(prog.instrs), len(prog.planes)
    instr = (ctypes.c_uint32 * n)(*prog.instrs)
    ptrs = (ctypes.c_void_p * npl)(*[p.data_ptr() for p in prog.planes])
    strides = (ctypes.c_longlong * npl)(*[p.stride(0) for p in prog.planes])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().fb_plan_eval(
            instr, n, prog.result, ptrs, strides, npl, S, W,
            words.data_ptr() if words is not None else None,
            counts.data_ptr() if counts is not None else None, stream)
    _check(rc, "plan_eval")
    plan_eval.launches += 1
    return words, counts


plan_eval.launches = 0


def row_counts(tile: torch.Tensor, filt: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """(S, R, W) int32 tile [& (S, W) int32 filter] -> (S, R) int64."""
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
    if not tile.is_contiguous() or (filt is not None
                                    and not filt.is_contiguous()):
        raise ValueError("row_counts needs contiguous tile and filter")
    out = torch.empty((S, R), dtype=torch.int64, device=tile.device)
    if S == 0 or R == 0:
        return out
    with torch.cuda.device(tile.device):
        stream = torch.cuda.current_stream(tile.device).cuda_stream
        rc = _lib().fb_row_counts(
            tile.data_ptr(), filt.data_ptr() if filt is not None else None,
            S, R, W, out.data_ptr(), stream)
    _check(rc, "row_counts")
    row_counts.launches += 1
    return out


row_counts.launches = 0


def reset_launches() -> None:
    plan_eval.launches = 0
    row_counts.launches = 0


def launches() -> Dict[str, int]:
    return {"plan_eval": plan_eval.launches, "row_counts": row_counts.launches}
