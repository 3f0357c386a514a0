"""Kernels of an earlier commit beside this tree's, on one card, in turns
(parent, change, change, parent).

    python3 -m featurebase_tpu_torch.tools.compare_parent PARENT \
        [--kernels bsi|rows|decode] [--reps 10]

PARENT is the root of an unpacked earlier commit of this repository (for
example ``git archive <rev> | tar -x -C _scratch/parent``).  Its sources are
built with this tree's nvcc flags into ``featurebase_tpu_torch/build/``.

``--kernels bsi`` (the default): the parent's
``featurebase_tpu_torch/csrc/bsi_kernels.cu`` holds the first kernels C
and D (a stacked (S, D + 2, W) group and an (S, W) filter,
``fb_bsi_sum_planes(group, filt, S, D, W, out, slots, n_slots, ticket,
stream)`` and ``fb_bsi_min_max`` alike, D running all four descents),
timed beside C' and D' (D' as a Min, held against the parent's pos-min and
neg-max): one shard at depth 14, two shards at depth 43, 128 stacked
shards at depth 14, and 128 shards' mirrors (the parent launched once a
shard there, C' and D' once).

``--kernels rows``: the parent's ``bitmap_kernels.cu`` and
``decode_kernels.cu`` hold the first kernel B (a block per (shard, row) of
a stacked tile, ``fb_row_counts(tile, filt, S, R, W, out, stream)``) and
kernel I (the same C interface as I').  B's shapes: a stacked (128, 8,
32768) tile with and without a filter, one shard of it, and 128 one-shard
mirrors.  I's: the prep pass and rounds of 2 (the min and the max), 4, 129
(a bisection round's pivots) and 512 thresholds over 128 shards of values.

``--kernels decode``: the parent's ``decode_kernels.cu`` holds the first
kernels G (a stacked group, ``fb_bsi_decode(group, shard_stride,
plane_stride, S, D, W, out, stream)``) and G' (one shard's group and device
columns, ``fb_bsi_decode_gather(group, plane_stride, D, cols, n, vals, ok,
stream)``), timed beside G'' and G''' (host columns, which the wrapper
uploads): G at depth 14 over 128 stacked shards, one shard and 128 shards'
mirrors (the parent launched once a shard there); G' at 1,000 and 65,536
columns of one shard and at 1,000 columns a shard over 128 shards' mirrors
(the parent launched once a shard).

Each shape's device time (torch.profiler, L2 flushed before each call) and
event time (CUDA events, chip_smoke.py's Timer) is printed as one JSON
line, and the card's name and power limit on the line before the last.
Every result is held against the plain version, exactly.  Exits nonzero
without CUDA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch


def build_parent(parent: str, source: str) -> ctypes.CDLL:
    """The parent's csrc/`source` built into this tree's build directory."""
    from featurebase_tpu_torch.ops import build
    src = os.path.join(parent, "featurebase_tpu_torch", "csrc", source)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    out = os.path.join(build.BUILD_DIR,
                       f"libparent_{os.path.splitext(source)[0]}.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(out)


def rows_cases(parent: str):
    """Kernels B and I of the parent beside B' and I': name -> (parent,
    change, plain, bytes), and the parent's launches a call where more than
    one."""
    import chip_smoke as c
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.ops import decode

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old_b = build_parent(parent, ck.SOURCE)
    old_b.fb_row_counts.argtypes = [vp, vp, i32, i32, i64, vp, vp]
    old_b.fb_row_counts.restype = i32
    old_i = build_parent(parent, ck.DECODE_SOURCE)
    old_i.fb_percentile_counts.argtypes = [vp, i64, vp, i64, vp, i64, i32,
                                           i64, i32, vp, i32, vp, vp]
    old_i.fb_percentile_counts.restype = i32
    old_i._fb_typed = True

    def old_row_counts(tile, filt=None):
        S, R, W = tile.shape
        out = torch.empty((S, R), dtype=torch.int64, device="cuda")
        rc = old_b.fb_row_counts(
            tile.data_ptr(), None if filt is None else filt.data_ptr(), S, R,
            W, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent row_counts: CUDA error {rc}")
        return out

    rng = np.random.default_rng(43)
    S, R, W = 128, 8, 32768
    tile = c.rand_words(rng, (S, R, W))
    filt = c.rand_words(rng, (S, W))
    one = tile[:1].contiguous()
    mirrors = [t.clone() for t in tile]
    slots = np.tile(np.arange(R), (S, 1))
    b_cases = {
        "row_counts/s128_filtered": (
            lambda: old_row_counts(tile, filt),
            lambda: ck.row_counts(tile, filt),
            lambda: ck.row_counts_plain(tile, filt),
            (S * R * W + S * W) * 4 + S * R * 8),
        "row_counts/s128_unfiltered": (
            lambda: old_row_counts(tile), lambda: ck.row_counts(tile),
            lambda: ck.row_counts_plain(tile), S * R * W * 4 + S * R * 8),
        "row_counts/s1_r8": (
            lambda: old_row_counts(one), lambda: ck.row_counts(one),
            lambda: ck.row_counts_plain(one), R * W * 4 + R * 8),
        "row_counts/mirrors_s128_r8": (
            lambda: torch.cat([old_row_counts(m[None]) for m in mirrors]),
            lambda: ck.row_counts_sharded(mirrors, slots),
            lambda: ck.row_counts_plain(tile), S * R * W * 4 + S * R * 8),
    }
    vals = torch.from_numpy(rng.integers(-1000, 10000, (S, 32 * W),
                                         dtype=np.int32)).cuda()
    exists = c.rand_words(rng, (S, W))
    ones = torch.full((S, W), -1, dtype=torch.int32, device="cuda")
    x = vals[decode.expand_bits(exists).bool()]
    mn, mx = int(x.min()), int(x.max())
    del x
    lo, hi = -(1 << 14), 1 << 14
    lists = {"prep": [], "k2": [mn, mx],
             "k4": sorted(rng.integers(mn, mx, 4).tolist()),
             "round_129": sorted({lo, hi, *decode.pivot_tree(
                 lo, hi, decode.PERCENTILE_LEVELS)}),
             "k512": sorted(rng.integers(mn, mx, 512).tolist())}
    real = ck._decode_lib

    def pct(lib, t):
        def run():
            ck._decode_lib = lambda: lib
            try:
                return ck.percentile_counts(vals, exists, ones, 0, t)
            finally:
                ck._decode_lib = real
        return run
    new_i = real()
    i_cases = {f"percentile_counts/s128_{n}": (
        pct(old_i, t), pct(new_i, t),
        lambda t=t: decode.percentile_counts_plain(vals, exists, ones, 0, t),
        S * 32 * W * 4 + 2 * S * W * 4 + (2 * len(t) + 3) * 8 + len(t) * 4)
        for n, t in lists.items()}
    return {**b_cases, **i_cases}, {"row_counts/mirrors_s128_r8": S}


def bsi_cases(parent: str):
    """Kernels C and D of the parent beside C' and D' (D' as a Min):
    name -> (parent, change, plain, bytes), and the parent's launches a
    call where more than one."""
    import chip_smoke as c
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.ops import cuda_kernels as ck

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old = build_parent(parent, ck.BSI_SOURCE)
    for fn in (old.fb_bsi_sum_planes, old.fb_bsi_min_max):
        fn.argtypes = [vp, vp, i32, i32, i64, vp, vp, i64, vp, vp]
        fn.restype = i32
    ticket = torch.zeros(1, dtype=torch.int32, device="cuda")

    def old_launch(name, group, filt, out_shape):
        S, P, W = group.shape
        out = torch.empty(out_shape, dtype=torch.int64, device="cuda")
        # the parent's tiles are 512 words at the least, 2D + 1 (C) or 8
        # (D) slots each
        slots = torch.empty(max(2 * P - 3, 8) * S * -(-W // 512),
                            dtype=torch.int64, device="cuda")
        rc = getattr(old, name)(
            group.data_ptr(), filt.data_ptr(), S, P - 2, W, out.data_ptr(),
            slots.data_ptr(), slots.numel(), ticket.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent {name}: CUDA error {rc}")
        return out

    def old_sum(group, filt):
        return old_launch("fb_bsi_sum_planes", group, filt,
                          (2 * group.shape[1] - 3,))

    def old_min(group, filt):
        """The parent's four descents with pos-max and neg-min zeroed: a
        Min's output."""
        out = old_launch("fb_bsi_min_max", group, filt,
                         (group.shape[0], 4, 2))
        out[:, 1:3] = 0
        return out

    rng = np.random.default_rng(29)
    W = 32768
    g128, f128 = c.rand_words(rng, (128, 16, W)), c.rand_words(rng, (128, W))
    g1, f1 = g128[:1].contiguous(), f128[:1].contiguous()
    g43, f43 = c.rand_words(rng, (2, 45, W)), c.rand_words(rng, (2, W))
    mirrors, rows = [g.clone() for g in g128], [f.clone() for f in f128]

    def nbytes(S, P, out_bytes):
        return (P + 1) * S * W * 4 + out_bytes
    cases = {}
    for key, g, f in (("s1_d14", g1, f1), ("s2_d43", g43, f43),
                      ("s128_d14", g128, f128)):
        S, P, _ = g.shape
        cases[f"bsi_sum_planes/{key}"] = (
            lambda g=g, f=f: old_sum(g, f),
            lambda g=g, f=f: ck.bsi_sum_planes(g, f),
            lambda g=g, f=f: bsiops.sum_planes_plain(g, f),
            nbytes(S, P, (2 * P - 3) * 8))
        cases[f"bsi_min_max/{key}"] = (
            lambda g=g, f=f: old_min(g, f),
            lambda g=g, f=f: ck.bsi_min_max(g, f, True),
            lambda g=g, f=f: bsiops.min_max_parts_plain(g, f, True),
            nbytes(S, P, S * 64))
    cases["bsi_sum_planes/mirrors_s128_d14"] = (
        lambda: torch.stack([old_sum(m[None], f[None])
                             for m, f in zip(mirrors, rows)]).sum(0),
        lambda: ck.bsi_sum_planes_sharded(mirrors, rows),
        lambda: bsiops.sum_planes_plain(g128, f128), nbytes(128, 16, 29 * 8))
    cases["bsi_min_max/mirrors_s128_d14"] = (
        lambda: torch.cat([old_min(m[None], f[None])
                           for m, f in zip(mirrors, rows)]),
        lambda: ck.bsi_min_max_sharded(mirrors, rows, True),
        lambda: bsiops.min_max_parts_plain(g128, f128, True),
        nbytes(128, 16, 128 * 64))
    calls = {(k, "parent"): 128 for k in cases if "mirrors" in k}
    return cases, calls


def decode_cases(parent: str):
    """Kernels G and G' of the parent beside G'' and G''': name -> (parent,
    change, plain, bytes), and the parent's launches a call where more than
    one."""
    import chip_smoke as c
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.ops import decode

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    old = build_parent(parent, ck.DECODE_SOURCE)
    old.fb_bsi_decode.argtypes = [vp, i64, i64, i32, i32, i64, vp, vp]
    old.fb_bsi_decode_gather.argtypes = [vp, i64, i32, vp, i64, vp, vp, vp]
    old.fb_bsi_decode.restype = old.fb_bsi_decode_gather.restype = i32

    def old_decode(group):
        S, P, W = group.shape
        out = torch.empty((S, 32 * W), dtype=torch.int32, device="cuda")
        rc = old.fb_bsi_decode(group.data_ptr(), group.stride(0),
                               group.stride(1), S, P - 2, W, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent bsi_decode: CUDA error {rc}")
        return out

    def old_gather(group, cols):
        """The parent's (vals, ok) of device columns, as one tensor."""
        n = cols.numel()
        out = torch.empty(2 * n, dtype=torch.int32, device="cuda")
        rc = old.fb_bsi_decode_gather(
            group.data_ptr(), group.stride(0), group.shape[0] - 2,
            cols.data_ptr(), n, out.data_ptr(), out[n:].data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent bsi_decode_gather: CUDA error {rc}")
        return out

    rng = np.random.default_rng(59)
    S, P, W = 128, 16, 32768
    group = c.rand_words(rng, (S, P, W))
    one = group[:1].contiguous()
    mirrors = [g.clone() for g in group]

    def nbytes(S):   # the sign and magnitude planes once; the values
        return (P - 1) * S * W * 4 + S * 32 * W * 4
    cases = {
        "bsi_decode/s128_d14": (
            lambda: old_decode(group), lambda: ck.bsi_decode(group),
            lambda: decode.decode_values_plain(group), nbytes(S)),
        "bsi_decode/s1_d14": (
            lambda: old_decode(one), lambda: ck.bsi_decode(one),
            lambda: decode.decode_values_plain(one), nbytes(1)),
        "bsi_decode/mirrors_s128_d14": (
            lambda: torch.cat([old_decode(m[None]) for m in mirrors]),
            lambda: ck.bsi_decode_sharded(mirrors),
            lambda: decode.decode_values_plain(group), nbytes(S)),
    }

    def gather_bytes(cols_per_shard):   # ids in, P words a word, 8 out
        words = sum(np.unique(x >> 5).size for x in cols_per_shard)
        n = sum(x.size for x in cols_per_shard)
        return n * 4 + words * P * 4 + n * 8
    for n in (1000, 1 << 16):
        cols = np.sort(rng.choice(32 * W, n, replace=False))
        dcols = torch.from_numpy(cols).to(torch.int32).cuda()
        cases[f"bsi_decode_gather/n{n}_d14"] = (
            lambda dcols=dcols: old_gather(group[0], dcols),
            lambda cols=cols: torch.cat(ck.bsi_decode_gather(group[0], cols)),
            lambda cols=cols: torch.cat(decode.decode_gather_plain(
                group[0], torch.from_numpy(cols).cuda())),
            gather_bytes([cols]))
    per = [np.sort(rng.choice(32 * W, 1000, replace=False))
           for _ in range(S)]
    dper = [torch.from_numpy(x).to(torch.int32).cuda() for x in per]

    def old_sharded():
        """The parent's launch a shard, as (vals of every shard, ok of
        every shard)."""
        parts = [old_gather(m, x).reshape(2, -1) for m, x in zip(mirrors, dper)]
        return torch.cat([torch.cat([p[0] for p in parts]),
                          torch.cat([p[1] for p in parts])])
    cases["bsi_decode_gather/mirrors_s128_n1000_d14"] = (
        old_sharded,
        lambda: torch.cat(ck.bsi_decode_gather_sharded(mirrors, per)),
        lambda: torch.cat(ck.bsi_decode_gather_sharded_plain(mirrors, per)),
        gather_bytes(per))
    calls = {(k, "parent"): S for k in cases if "mirrors" in k}
    return cases, calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("--kernels", choices=("bsi", "rows", "decode"),
                    default="bsi")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_parent: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c

    make = {"bsi": bsi_cases, "rows": rows_cases,
            "decode": decode_cases}[args.kernels]
    cases, calls = make(args.parent)
    timer = c.Timer(args.reps)
    prefixes = ("row_counts", "percentile", "bsi_sum_planes", "bsi_min_max",
                "bsi_decode")
    for name, (old, new, plain, nbytes) in cases.items():
        want = plain()
        for what, fn in (("parent", old), ("change", new)):
            got = fn()
            if not torch.equal(got.cpu(), want.cpu()):
                raise AssertionError(f"{name}: {what} disagrees with the "
                                     "plain version")
        times = {}
        for what, fn in (("parent", old), ("change", new), ("change", new),
                         ("parent", old)):
            dev = c.kernel_device_ms(fn, args.reps)
            kernel = [k for k in dev if k.startswith(prefixes)]
            times.setdefault(what, []).append(dict(
                ms=timer(fn), device_ms=calls.get((name, what), 1)
                * sum(dev[k] for k in kernel)))
        print(json.dumps({"shape": name, "bytes": nbytes,
                          "bound_ms": nbytes / c.HBM_BYTES_PER_S * 1e3,
                          **times}), flush=True)
    print(c.card_line())
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
