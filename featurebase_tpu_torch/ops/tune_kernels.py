"""The count-and tuning kernels, with their plain PyTorch versions.

Counterpart of the three Pallas kernels of tools/tune_count_kernel.py.  They
become four CUDA kernels (csrc/tune_count.cu, built by ops/build.py and loaded
with ctypes), each ``(a, b, acc) -> (1, 1) int32`` over two streams of int32
words, with the result taken mod 2^32 as the TPU's int32 sums wrap:

- ``tune_ceiling`` replaces ``build_ceiling.run`` (:85): acc + sum of
  (a ^ b) over every word.  The TPU ceiling folds only row 0 of each block,
  since its DMA moves whole blocks whatever the body touches; a GPU loads
  only what is used, so this one folds every word and its value differs.
  Neither is a popcount.
- ``tune_csa_scalar`` replaces ``build_csa_smem.run`` (:121): acc +
  popcount(a & b) through a 4-way carry-save adder, one atomic add a block
  into one 32-bit counter.
- ``tune_direct_partial`` and ``tune_csa_partial`` replace ``_partial_call``
  (:140) with its two bodies (:160, :176): one partial a block, no atomics,
  acc added into block 0's partial, and the partials summed here with
  ``torch.sum(parts, dtype=torch.int32)`` as the JAX tool sums with
  ``jnp.sum``.

Every kernel runs at a launch shape ``(threads, vec)``: threads per block and
16-byte loads in flight per stream per thread, one of ``SHAPES``.  Bound:
bytes, 2 x n x 4 read.  Each wrapper takes its plain version only for
tensors on the CPU; on a CUDA tensor it launches the kernel or raises.
``launches`` on each wrapper counts kernel launches (never plain calls).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from featurebase_tpu_torch.ops.cuda_kernels import _check, _is_cpu, \
    popcount_words

SOURCE = "tune_count.cu"

# (threads, vec) launch shapes, the ones FB_TUNE_SHAPES instantiates in
# csrc/tune_count.cu.
SHAPES = ((128, 8), (256, 1), (256, 2), (256, 4), (256, 8), (512, 2),
          (512, 4), (1024, 1), (1024, 2))
DEFAULT_SHAPE = (256, 4)

# kernel name -> (C launcher, kind in csrc/tune_count.cu, result is a
# per-block partial)
_KERNELS = {
    "tune_ceiling": ("fb_tune_ceiling", 0, False),
    "tune_csa_scalar": ("fb_tune_csa_scalar", 1, False),
    "tune_direct_partial": ("fb_tune_direct_partial", 2, True),
    "tune_csa_partial": ("fb_tune_csa_partial", 3, True),
}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def wrap32(total: torch.Tensor) -> torch.Tensor:
    """An int64 total taken mod 2^32, as a (1, 1) int32 tensor."""
    x = total.reshape(1, 1).to(torch.int64) & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _acc64(acc: torch.Tensor) -> torch.Tensor:
    return acc.reshape(()).to(torch.int64)


def ceiling_plain(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor
                  ) -> torch.Tensor:
    """acc + sum of the uint32 words of (a ^ b), mod 2^32."""
    x = (a ^ b).reshape(-1).to(torch.int64) & 0xFFFFFFFF
    return wrap32(x.sum() + _acc64(acc))


def count_and_direct_plain(a: torch.Tensor, b: torch.Tensor,
                           acc: torch.Tensor) -> torch.Tensor:
    """acc + popcount(a & b), mod 2^32."""
    return wrap32(popcount_words(a & b).sum() + _acc64(acc))


def count_and_csa_plain(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor
                        ) -> torch.Tensor:
    """acc + popcount(a & b) mod 2^32, through the kernel's carry-save adder
    over each four consecutive words; the < 4 words left over are counted
    directly."""
    x = (a & b).reshape(-1)
    n4 = x.numel() // 4 * 4
    w0, w1, w2, w3 = x[:n4].reshape(-1, 4).unbind(1)
    xy = w0 ^ w1
    s1, c1 = xy ^ w2, (w0 & w1) | (xy & w2)
    ones, c2 = s1 ^ w3, s1 & w3
    total = (popcount_words(ones).sum()
             + 2 * (popcount_words(c1).sum() + popcount_words(c2).sum())
             + popcount_words(x[n4:]).sum())
    return wrap32(total + _acc64(acc))


PLAIN = {
    "tune_ceiling": ceiling_plain,
    "tune_csa_scalar": count_and_csa_plain,
    "tune_direct_partial": count_and_direct_plain,
    "tune_csa_partial": count_and_csa_plain,
}


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _lib() -> ctypes.CDLL:
    from featurebase_tpu_torch.ops import build
    lib = build.load(SOURCE)
    if not getattr(lib, "_fb_typed", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, _, _ in _KERNELS.values():
            getattr(lib, fn).argtypes = [vp, vp, i64, vp, vp, i32, i32, i32,
                                         vp]
            getattr(lib, fn).restype = i32
        lib.fb_tune_grid.argtypes = [i32, i32, i32, i64, ctypes.POINTER(i32)]
        lib.fb_tune_grid.restype = i32
        lib._fb_typed = True
    return lib


def _run(wrapper, a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor,
         threads: int, vec: int) -> torch.Tensor:
    name = wrapper.__name__
    if a.dtype != torch.int32 or b.dtype != torch.int32 \
            or a.shape != b.shape:
        raise ValueError(f"streams must be int32 of one shape, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} "
                         f"{b.dtype}")
    if acc.dtype != torch.int32 or acc.numel() != 1:
        raise ValueError(f"acc must be one int32 word, got "
                         f"{tuple(acc.shape)} {acc.dtype}")
    if (threads, vec) not in SHAPES:
        raise ValueError(f"launch shape {threads}x{vec} is not one of "
                         f"{SHAPES}")
    if _is_cpu([a, b, acc]):
        return PLAIN[name](a, b, acc)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} needs contiguous streams")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned streams")
    acc = acc.contiguous()
    n = a.numel()
    if n == 0:
        return acc.reshape(1, 1).clone()
    fn, kind, partial = _KERNELS[name]
    lib = _lib()
    with torch.cuda.device(a.device):
        blocks = ctypes.c_int()
        _check(lib.fb_tune_grid(kind, threads, vec, n, ctypes.byref(blocks)),
               f"{name} grid")
        out = torch.empty((blocks.value if partial else 1,),
                          dtype=torch.int32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = getattr(lib, fn)(a.data_ptr(), b.data_ptr(), n, acc.data_ptr(),
                              out.data_ptr(), threads, vec, blocks.value,
                              stream)
    _check(rc, name)
    wrapper.launches += 1
    if partial:
        out = torch.sum(out, dtype=torch.int32)
    return out.reshape(1, 1)


def tune_ceiling(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor,
                 threads: int = DEFAULT_SHAPE[0], vec: int = DEFAULT_SHAPE[1]
                 ) -> torch.Tensor:
    """acc + sum(a ^ b) mod 2^32 -> (1, 1) int32: the two-stream read
    ceiling."""
    return _run(tune_ceiling, a, b, acc, threads, vec)


def tune_csa_scalar(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor,
                    threads: int = DEFAULT_SHAPE[0],
                    vec: int = DEFAULT_SHAPE[1]) -> torch.Tensor:
    """acc + popcount(a & b) mod 2^32 -> (1, 1) int32: CSA, one counter."""
    return _run(tune_csa_scalar, a, b, acc, threads, vec)


def tune_direct_partial(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor,
                        threads: int = DEFAULT_SHAPE[0],
                        vec: int = DEFAULT_SHAPE[1]) -> torch.Tensor:
    """acc + popcount(a & b) mod 2^32 -> (1, 1) int32: per-block partials."""
    return _run(tune_direct_partial, a, b, acc, threads, vec)


def tune_csa_partial(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor,
                     threads: int = DEFAULT_SHAPE[0],
                     vec: int = DEFAULT_SHAPE[1]) -> torch.Tensor:
    """acc + popcount(a & b) mod 2^32 -> (1, 1) int32: CSA, per-block
    partials."""
    return _run(tune_csa_partial, a, b, acc, threads, vec)


KERNELS = {f.__name__: f for f in (tune_ceiling, tune_csa_scalar,
                                   tune_direct_partial, tune_csa_partial)}


def reset_launches() -> None:
    for f in KERNELS.values():
        f.launches = 0


def launches() -> Dict[str, int]:
    return {name: f.launches for name, f in KERNELS.items()}


reset_launches()
