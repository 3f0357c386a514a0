#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (featurebase_tpu_torch) on a GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--shards 128] [--reps 20]

Phases, one status line each; any failure raises and exits nonzero:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build of every CUDA source with nvcc (sm_90a), timed, with the ptxas
     register/shared-memory report;
  3. each kernel against its plain PyTorch version on the card, at the
     slice's shapes, on random words from a numpy seed: exact equality;
  4. kernel times (CUDA events, L2 flushed before each launch, median of
     --reps; and each CUDA kernel's own device time from torch.profiler)
     beside the bytes bound at 3.35 TB/s, the measured device-to-device
     copy ceiling and the plain version's time;
  5. the slice: a --shards table (625,000 records per shard; set fields f
     and g, int field v in [-1000, 10000]) built through the port's import
     API, the query mix run through Executor(holder) on cuda, every answer
     equal to a CPU executor over the same Holder and to a numpy oracle on
     Count(Intersect), Count(Row(v > 5000)) and TopN(f, n=5); both kernels'
     launch counters must rise; TopN's per-shard branch must give the
     stacked answers; p50 latency per query.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Without CUDA it exits nonzero at once.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
RECORDS_PER_SHARD = 625_000
QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=3)))",
    "Count(Difference(Row(f=1), Row(g=0)))",
    "Count(Xor(Row(f=1), Row(g=1)))",
    "Count(Not(Row(f=1)))",
    "Count(Row(v > 5000))",
    "Count(Row(v <= -10))",
    "Count(Row(v == 42))",
    "Count(Row(0 < v < 100))",
    "Count(Intersect(Row(f=1), Row(v > 5000)))",
    "Count(Shift(Row(f=1), n=1))",
    "Row(f=3)",
    "TopN(f, n=5)",
    "TopN(f, Row(g=2), n=5)",
    "TopN(f, Row(v > 5000), n=5)",
    "Options(Count(Row(f=1)), shards=[0, 5, 63])",
]


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- timing -------------------------------------------------------------------

class Timer:
    """Median device time of a callable with CUDA events.  Before each
    launch a 128 MB write evicts the 50 MB L2, so inputs come from HBM, and
    a spin kernel keeps the card busy while the host records the start
    event and enqueues the call, so host time in the wrapper is not
    counted."""

    def __init__(self, reps: int):
        self.reps = reps
        self.flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")

    def __call__(self, fn) -> float:
        fn()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)   # ~0.5 ms of device time
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def kernel_device_ms(fn, reps: int) -> dict:
    """Device time per launch of each CUDA kernel that `fn` runs, from
    torch.profiler (CUPTI), L2 flushed before each call: the kernels alone,
    without the launch gaps that the event timing includes."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    names = ("plan_eval_kernel", "row_counts_kernel", "Memset")
    return {next((n for n in names if n in ev.key), ev.key[:60]):
            ev.device_time_total / ev.count / 1e3
            for ev in prof.key_averages()
            if ev.device_time_total > 0 and "FillFunc" not in ev.key}


def rand_words(rng, shape) -> torch.Tensor:
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32)).cuda()


def bsi_gt_program(bsi: torch.Tensor, pred: int):
    from featurebase_tpu_torch.ops import bsi_traced as bst
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    depth = bsi.shape[1] - 2
    pb = ck.ProgramBuilder(bsi.shape[0], bsi.shape[2])
    bits, neg = bst.encode_pred(pred, depth)
    r = bst.lower_gt(pb, bst.BsiPlanes(pb, "v", bsi), bits, int(neg), depth,
                     False)
    return pb.build(r)


def and_program(a: torch.Tensor, b: torch.Tensor):
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    pb = ck.ProgramBuilder(*a.shape)
    r = pb.op(ck.OP_AND, pb.load(pb.plane(0, a)), pb.load(pb.plane(1, b)))
    return pb.build(r)


def max_err(x: torch.Tensor, y: torch.Tensor) -> int:
    return int((x.to(torch.int64) - y.to(torch.int64)).abs().max())


def require_equal(what: str, x: torch.Tensor, y: torch.Tensor) -> int:
    """Max abs difference of a kernel result and its plain version; raises
    unless it is 0 (the outputs are integer words and counts)."""
    if x.shape != y.shape:
        raise AssertionError(f"{what}: shape {tuple(x.shape)} != "
                             f"{tuple(y.shape)}")
    err = max_err(x, y)
    if err != 0:
        raise AssertionError(f"{what}: kernel disagrees with plain version "
                             f"(max abs err {err})")
    return err


# -- phases -------------------------------------------------------------------

def kernel_parity(S: int, depth: int, R: int):
    """Phase 3: exact kernel-vs-plain parity at the slice's shapes."""
    from featurebase_tpu_torch.ops import bitwise as bw
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    W = 32768
    rng = np.random.default_rng(7)
    a, b = rand_words(rng, (S, W)), rand_words(rng, (S, W))
    bsi = rand_words(rng, (S, depth + 2, W))
    tile, filt = rand_words(rng, (S, R, W)), rand_words(rng, (S, W))
    errs_a, errs_b = [], []
    for name, prog in (("and", and_program(a, b)),
                       ("bsi_gt", bsi_gt_program(bsi, 5000))):
        kw, kc = ck.plan_eval(prog, True, True)
        pw, pc = ck.plan_eval_plain(prog, True, True)
        errs_a.append(require_equal(f"plan_eval {name} words", kw, pw))
        errs_a.append(require_equal(f"plan_eval {name} counts", kc, pc))
    acc = torch.tensor([[12345]], dtype=torch.int32, device="cuda")
    errs_a.append(require_equal(
        "count_and with acc", bw.count_and(a, b, acc),
        ck.popcount_words(a & b).sum() + 12345))
    odd = a.reshape(-1)[: 1000003]   # irregular size: the scalar path
    errs_a.append(require_equal(
        "count_and odd size", bw.count_and(odd, odd.flip(0)),
        ck.popcount_words(odd & odd.flip(0)).sum()))
    for s in (S, 1):
        for f in (None, filt[:s]):
            errs_b.append(require_equal(
                f"row_counts S={s} filter={f is not None}",
                ck.row_counts(tile[:s], f), ck.row_counts_plain(tile[:s], f)))
    torch.cuda.synchronize()
    errs = {"plan_eval": max(errs_a), "row_counts": max(errs_b)}
    say("kernel_parity", ok=True, shapes={"S": S, "W": W, "R": R,
                                          "bsi_planes": depth + 2},
        checks=["plan_eval and (words, counts)", "plan_eval bsi_gt",
                "count_and + acc", "count_and odd size",
                "row_counts S/1 x filtered/unfiltered"])
    return errs, dict(a=a, b=b, bsi=bsi, tile=tile, filt=filt)


def kernel_times(timer: Timer, inputs) -> dict:
    """Phase 4: kernel vs plain vs bound vs copy ceiling."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    big = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    big2 = torch.empty_like(big)
    copy_ms = timer(lambda: big2.copy_(big))
    copy_bps = 2 * big.numel() * 4 / (copy_ms / 1e3)
    say("copy_ceiling", bytes=2 * big.numel() * 4, ms=copy_ms,
        gb_per_s=copy_bps / 1e9)
    a, b, bsi = inputs["a"], inputs["b"], inputs["bsi"]
    tile, filt = inputs["tile"], inputs["filt"]
    S, R, W = tile.shape
    gt = bsi_gt_program(bsi, 5000)
    cases = {
        "plan_eval/and_count": (and_program(a, b), 2),
        "plan_eval/bsi_gt_count": (gt, len(gt.planes)),
    }
    out = {}
    def measure(fn, plain, nbytes):
        return dict(ms=timer(fn), plain_ms=timer(plain),
                    device_ms=kernel_device_ms(fn, timer.reps), bytes=nbytes,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    copy_ceiling_ms=nbytes / copy_bps * 1e3)

    for name, (prog, nplanes) in cases.items():
        out[name] = measure(lambda: ck.plan_eval(prog, False, True),
                            lambda: ck.plan_eval_plain(prog, False, True),
                            nplanes * S * W * 4 + S * 8)
    for name, f in (("row_counts/unfiltered", None),
                    ("row_counts/filtered", filt)):
        out[name] = measure(
            lambda: ck.row_counts(tile, f),
            lambda: ck.row_counts_plain(tile, f),
            (S * R * W + (0 if f is None else S * W)) * 4 + S * R * 8)
    for name, r in out.items():
        say("kernel_time", kernel=name, **r)
    return out


def build_table(n_shards: int, seed: int = 0):
    """The slice's table through the port's import API, plus the generating
    arrays for the oracle."""
    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    from featurebase_tpu_torch.model.field import FieldOptions
    from featurebase_tpu_torch.model.index import Holder
    rng = np.random.default_rng(seed)
    cols = np.concatenate([
        s * SHARD_WIDTH + np.sort(rng.choice(SHARD_WIDTH, RECORDS_PER_SHARD,
                                             replace=False))
        for s in range(n_shards)]).astype(np.int64)
    n = cols.size
    f_rows = rng.integers(0, 8, size=n)
    g_rows = rng.integers(0, 4, size=n)
    vals = rng.integers(-1000, 10000, size=n)
    holder = Holder()
    idx = holder.create_index("bench")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", FieldOptions(type="int", min=-1000, max=10000))
    idx.field("f").import_bits(f_rows, cols)
    idx.field("g").import_bits(g_rows, cols)
    idx.field("v").import_values(cols, vals)
    idx.mark_exists(cols)
    return holder, dict(f=f_rows, g=g_rows, v=vals)


def canon(result):
    """Comparable form of a query result."""
    from featurebase_tpu_torch.executor.results import PairsField
    from featurebase_tpu_torch.model.row import Row
    if isinstance(result, Row):
        return ("row", result.columns().tolist())
    if isinstance(result, PairsField):
        return ("pairs", [(p.id, p.count) for p in result.pairs])
    return ("value", int(result))


def slice_phase(n_shards: int, reps: int) -> dict:
    """Phase 5: the main path at full size, through Executor(holder)."""
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.model.row import Row
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    t0 = time.perf_counter()
    holder, gen = build_table(n_shards)
    build_s = time.perf_counter() - t0
    idx = holder.index("bench")
    say("table", shards=n_shards, records=int(gen["f"].size),
        bit_depth=idx.field("v").bit_depth, build_s=build_s)
    queries = [q for q in QUERIES
               if "shards=" not in q or n_shards > 63]
    rank_cache = idx.field("f")._topn_cache

    def run(executor, q):
        rank_cache.clear()   # TopN then counts on the kernel path
        return canon(executor.execute("bench", q)[0])

    gpu = Executor(holder)
    ck.reset_launches()
    t0 = time.perf_counter()
    answers = {q: run(gpu, q) for q in queries}
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ck.launches()
    say("main_path", first_pass_s=first_s, launches=launches)
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} was not launched by the "
                                 "main path")
    cpu = Executor(holder, device="cpu")
    for q in queries:
        want = run(cpu, q)
        if answers[q] != want:
            raise AssertionError(f"{q}: cuda {answers[q][1]!r:.200} != "
                                 f"cpu {want[1]!r:.200}")
    f, g, v = gen["f"], gen["g"], gen["v"]
    oracle = {
        "Count(Intersect(Row(f=1), Row(g=2)))":
            ("value", int(((f == 1) & (g == 2)).sum())),
        "Count(Row(v > 5000))": ("value", int((v > 5000).sum())),
    }
    top = np.bincount(f, minlength=8)
    order = sorted(range(8), key=lambda r: (-top[r], r))[:5]
    oracle["TopN(f, n=5)"] = ("pairs", [(r, int(top[r])) for r in order])
    for q, want in oracle.items():
        if answers[q] != want:
            raise AssertionError(f"{q}: engine {answers[q]} != oracle {want}")
    say("answers", equal_to_cpu=True, equal_to_oracle=sorted(oracle),
        counts={q: a[1] for q, a in answers.items() if a[0] == "value"})
    # TopN's per-shard branch (taken above ROWS_STACKED_MAX_BYTES): the
    # (R, W) forms of kernel B, one launch per shard
    per_shard = Executor(holder)
    per_shard.ROWS_STACKED_MAX_BYTES = 0
    topn = [q for q in queries if q.startswith("TopN")]
    for q in topn:
        got = run(per_shard, q)
        if got != answers[q]:
            raise AssertionError(f"{q}: per-shard TopN {got} != stacked "
                                 f"{answers[q]}")
    say("topn_per_shard", equal_to_stacked=topn)
    latency = {}
    for q in queries:
        times = []
        for _ in range(reps):
            rank_cache.clear()
            t0 = time.perf_counter()
            result = gpu.execute("bench", q)[0]
            if isinstance(result, Row):
                result.columns()   # the decode a caller needs, no list
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        latency[q] = float(np.median(times))
    say("latency_p50_ms", **latency)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from featurebase_tpu_torch.ops import build
    from featurebase_tpu_torch.ops import cuda_kernels as ck

    card = card_line()
    say("card", nvidia_smi=card, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    build.build([ck.SOURCE])
    say("build", seconds=time.perf_counter() - t0,
        ptxas=[ln for ln in build.build_log.get(ck.SOURCE, "").splitlines()
               if "registers" in ln or "Compiling entry" in ln])

    S, depth, R = args.shards, 14, 8
    errs, inputs = kernel_parity(S, depth, R)
    times = kernel_times(Timer(args.reps), inputs)
    del inputs
    launches = slice_phase(args.shards, args.reps)

    kernels = []
    for name, key, replaces in (
            ("plan_eval", "plan_eval/bsi_gt_count",
             "featurebase_tpu/ops/pallas_kernels.py:135"),
            ("row_counts", "row_counts/filtered",
             "featurebase_tpu/ops/pallas_kernels.py:172")):
        t = times[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "featurebase_tpu_torch/csrc/bitmap_kernels.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
