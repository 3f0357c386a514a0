"""Tuning harness for count-and on the GPU (port of tools/tune_count_kernel.py).

Measures with the same two-point fit as the JAX tool: K launches chained
through ``acc`` with no host sync between them, best of 3 for each of two K,
``t_iter = (t(K2) - t(K1)) / (K2 - K1)``, so constant overheads cancel.  Each
stream is 256 MB on the card (two streams cannot sit in the 50 MB L2) and
16 MB on the CPU.  Variants:

  ceiling_dma      tune_ceiling at the default launch shape: both streams
                   read with 16-byte loads and xor-summed, the measured
                   two-stream read ceiling of this card
  compiled_direct  torch.compile of the plain popcount(a & b) sum: what a
                   fusing compiler gives; a yardstick, not a kernel of the
                   port (counterpart of the JAX tool's xla_direct)
  torch_direct     the eager plain version, a labelled reference
  ceiling_TxV      tune_ceiling with T threads a block and V 16-byte loads in
                   flight per stream per thread
  csa_TxV          tune_csa_scalar: 4-way CSA, one atomic a block into one
                   32-bit counter (the production shape of the JAX tool)
  direct_TxV       tune_direct_partial: popcount, one partial a block, final
                   sum outside the kernel
  csa_p_TxV        tune_csa_partial: 4-way CSA with per-block partials

Usage: python -m featurebase_tpu_torch.tools.tune_count_kernel
           [--device cpu] [variant ...]
Prints one JSON line per variant, an error line for a variant that fails,
and exits nonzero if any failed.  Runs on CUDA unless given --device cpu.
"""
from __future__ import annotations

import argparse
import functools
import json
import sys
import time
import traceback
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from featurebase_tpu_torch.ops import tune_kernels as tk

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
CUDA_BYTES, CPU_BYTES = 256 << 20, 16 << 20   # per stream
CUDA_KS, CPU_KS = (30, 130), (2, 6)
REPS = 3   # best of

# variant -> (what runs, threads, vec); threads = vec = 0 for the
# whole-tensor variants
VARIANTS: Dict[str, Tuple[str, int, int]] = {}
for _t, _v in tk.SHAPES:
    VARIANTS[f"ceiling_{_t}x{_v}"] = ("tune_ceiling", _t, _v)
    VARIANTS[f"csa_{_t}x{_v}"] = ("tune_csa_scalar", _t, _v)
    VARIANTS[f"direct_{_t}x{_v}"] = ("tune_direct_partial", _t, _v)
    VARIANTS[f"csa_p_{_t}x{_v}"] = ("tune_csa_partial", _t, _v)
VARIANTS["ceiling_dma"] = ("tune_ceiling", *tk.DEFAULT_SHAPE)
VARIANTS["compiled_direct"] = ("compiled", 0, 0)
VARIANTS["torch_direct"] = ("plain", 0, 0)

# a ceiling, the compiler yardstick, then each design at the default shape
# and at two more
DEFAULT = ["ceiling_dma", "compiled_direct"] + [
    f"{design}_{t}x{v}" for t, v in (tk.DEFAULT_SHAPE, (1024, 1), (128, 8))
    for design in ("csa", "direct", "csa_p")]


def make_inputs(nbytes: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two streams of random int32 words, nbytes each, from numpy seed 0."""
    rng = np.random.default_rng(0)
    n = nbytes // 4
    return tuple(
        torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
                         .view(np.int32)).to(device)
        for _ in range(2))


@functools.lru_cache(maxsize=1)
def _compiled_direct() -> Callable:
    import torch._inductor.config as inductor_config
    # compile in this process: Inductor's pool of compile workers would
    # outlive the measurement and compete with the host for its cores
    inductor_config.compile_threads = 1
    return torch.compile(tk.count_and_direct_plain, dynamic=False)


def variant_fn(variant: str) -> Callable:
    """fn(a, b, acc) -> (1, 1) int32 for a variant."""
    kind, threads, vec = VARIANTS[variant]
    if kind == "compiled":
        return _compiled_direct()
    if kind == "plain":
        return tk.count_and_direct_plain
    return functools.partial(tk.KERNELS[kind], threads=threads, vec=vec)


def numpy_ref(kind: str, a: torch.Tensor, b: torch.Tensor) -> int:
    """The variant's value with acc = 0, from numpy, mod 2^32."""
    x = a.cpu().numpy().view(np.uint32)
    y = b.cpu().numpy().view(np.uint32)
    if kind == "tune_ceiling":
        return int(np.sum(x ^ y, dtype=np.uint64)) % (1 << 32)
    return int(np.sum(np.bitwise_count(x & y), dtype=np.uint64)) % (1 << 32)


def _u32(x: torch.Tensor) -> int:
    return int(x.reshape(())) % (1 << 32)


def _chain(fn: Callable, a: torch.Tensor, b: torch.Tensor, k: int
           ) -> Tuple[float, int]:
    """Seconds for k launches chained through acc, and the final acc."""
    acc = torch.zeros((1, 1), dtype=torch.int32, device=a.device)
    t0 = time.perf_counter()
    for _ in range(k):
        acc = fn(a, b, acc)
    out = _u32(acc)   # waits for the device
    return time.perf_counter() - t0, out


def measure(variant: str, device,
            inputs: Tuple[torch.Tensor, torch.Tensor]) -> dict:
    """Check one variant on `inputs` (two streams from make_inputs, on
    `device`) and time it; returns its JSON line as a dict.  Raises if the
    variant is unknown or gives a wrong value."""
    from featurebase_tpu_torch.executor.executor import resolve_device
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    kind, threads, vec = VARIANTS[variant]
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    a_flat, b_flat = inputs
    k1, k2 = CUDA_KS if on_cuda else CPU_KS
    fn = variant_fn(variant)
    # the bytes counted are the bytes read: whole steps of one block
    block = threads * vec * 4 if threads else a_flat.numel()
    n_use = a_flat.numel() // block * block
    if n_use == 0:
        raise ValueError(f"{variant}: fewer than {block} words a stream")
    a, b = a_flat[:n_use], b_flat[:n_use]
    zero = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    # cheap parity: one block against numpy
    got = _u32(fn(a[:block], b[:block], zero))
    want = numpy_ref(kind, a[:block], b[:block])
    if got != want:
        raise AssertionError(f"{variant}: parity {got} != {want}")
    # the whole input against the plain version on the same device
    once = _u32(fn(a, b, zero))
    plain = tk.PLAIN.get(kind, tk.count_and_direct_plain)
    if once != _u32(plain(a, b, zero)):
        raise AssertionError(f"{variant}: {once} != plain version")
    times = {}
    for k in (k1, k2):
        best = float("inf")
        for _ in range(REPS + 1):   # the first run warms up
            t, out = _chain(fn, a, b, k)
            if out != k * once % (1 << 32):
                raise AssertionError(f"{variant}: {k} chained launches gave "
                                     f"{out}, not {k} x {once} mod 2^32")
            best = min(best, t)
        times[k] = best
    t_iter = (times[k2] - times[k1]) / (k2 - k1)
    nbytes = 2 * n_use * 4
    bps = nbytes / t_iter
    return {
        "variant": variant, "kernel": kind, "threads": threads, "vec": vec,
        "device": torch.cuda.get_device_name(dev) if on_cuda else "cpu",
        "bytes": nbytes, "ks": [k1, k2], "t_iter_us": t_iter * 1e6,
        "gb_per_s": bps / 1e9,
        "pct_3350": bps / HBM_BYTES_PER_S * 100 if on_cuda else None,
        "exact": kind != "tune_ceiling",
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    from featurebase_tpu_torch.executor.executor import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("variants", nargs="*",
                    help=f"default: {' '.join(DEFAULT)}")
    args = ap.parse_args(argv)
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    dev = resolve_device(args.device)
    inputs = make_inputs(CUDA_BYTES if dev.type == "cuda" else CPU_BYTES,
                         dev)
    failed = 0
    for name in args.variants or DEFAULT:
        try:
            line = measure(name, dev, inputs)
        except Exception as e:  # noqa: BLE001 - report, go on, exit nonzero
            traceback.print_exc()
            print(json.dumps({"variant": name,
                              "error": f"{type(e).__name__}: {e}"[:300]}),
                  flush=True)
            failed += 1
            continue
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
