"""How often torch.profiler loses device events, on one card.

    python3 -m featurebase_tpu_torch.tools.profiler_windows [--windows 3000]

Opens ``--windows`` profiler windows the way ``chip_smoke.kernel_device_ms``
does (CUDA activity only; in each, 20 times an L2 flush by a fill of 128 MB
and one call), cycling over the four tuning kernels at their best shapes on
the harness's 256 MB streams and on 16 MB ones, and a torch ``add_``.  A
window is complete when it holds 20 fills and as many other kernel events
as most windows of its call.  Prints one JSON object: the torch and CUDA
versions, the windows of each call, and each incomplete window as
``[index, seconds, fills, other events]``.
"""
import argparse
import json
import time
from collections import Counter

import torch

REPS = 20
SHAPES = {"tune_ceiling": (256, 4), "tune_csa_scalar": (128, 8),
          "tune_direct_partial": (128, 8), "tune_csa_partial": (1024, 1)}


def calls() -> list:
    """(name, fn) of every call the windows cycle over."""
    from featurebase_tpu_torch.ops import tune_kernels as tk
    from featurebase_tpu_torch.tools import tune_count_kernel as harness
    big = harness.make_inputs(harness.CUDA_BYTES, torch.device("cuda"))
    small = tuple(x[:1 << 22] for x in big)
    acc = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    out = []
    for size, (x, y) in (("harness", big), ("small", small)):
        for name, (t, v) in SHAPES.items():
            k = tk.KERNELS[name]
            out.append((f"{name}/{size}", lambda k=k, t=t, v=v, x=x, y=y:
                        k(x, y, acc, threads=t, vec=v)))
    a = torch.zeros(1 << 22, dtype=torch.int32, device="cuda")
    out.append(("torch_add", lambda: a.add_(1)))
    return out


def window(fn) -> tuple:
    """(fills, other device events) of one window."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    fills = other = 0
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            if "FillFunc" in ev.key:
                fills += ev.count
            else:
                other += ev.count
    return fills, other


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=3000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_windows: CUDA is not available")
    fns = calls()
    seen, t0 = {}, time.perf_counter()
    for i in range(args.windows):
        name, fn = fns[i % len(fns)]
        fills, other = window(fn)
        seen.setdefault(name, []).append(
            [i, round(time.perf_counter() - t0, 2), fills, other])
    incomplete = {}
    for name, rows in seen.items():
        usual = Counter(r[3] for r in rows).most_common(1)[0][0]
        bad = [r for r in rows if r[2] != REPS or r[3] != usual]
        if bad:
            incomplete[name] = bad
    print(json.dumps({
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "windows": args.windows,
        "per_call": {k: len(v) for k, v in seen.items()},
        "incomplete": sum(len(v) for v in incomplete.values()),
        "empty": sum(1 for v in incomplete.values() for r in v
                     if r[2] == 0 and r[3] == 0),
        "windows_incomplete": incomplete,
        "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
