"""Kernels of an earlier commit beside this tree's, on one card, in turns
(parent, change, change, parent).

    python3 -m featurebase_tpu_torch.tools.compare_parent PARENT \
        [--kernels bsi|rows|decode|moments] [--reps 10]

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

``--kernels moments``: the parent's ``group_kernels.cu`` holds the first
kernel H, a third mode of kernels E and F's product: ``fb_group_product(
spec, W, table, out, slots, n_slots, tickets, n_tickets, stream)`` with the
15-word spec ``[2, vec, S, P, nf, Dx, Dy, 0, x_col, y_col, 0, filt_col, 0,
0, 0]`` over an (S, P) table of row addresses (the filter's column, then
each group's D + 2 planes), writing the (K, K) product of the K = sum(2D +
1) sign classes (scratch from ``fb_group_product_slots(spec, W, &n_slots,
&n_tickets, &chunk_words)``; tickets zero before the launch).  Timed
beside H': Var at depth 14 and Corr at depths 14 and 12, stacked at S =
128 and S = 1 and in one launch over 128 shards' mirrors (the sharded
wrappers; the parent over the same address table); Var at depth 31 and
Corr at 31 x 31 at S = 128.  Then, at S = 128 for Var 14 and Corr 14 x 12:
the ablation builds of the parent and of H' (``-DFB_ABLATE_COPY``: no copies;
``-DFB_ABLATE_COMPUTE``: no product), each form's registers (ptxas) and
resident blocks an SM (H': the planner's, from the occupancy API; the
parent: from its registers and shared bytes; the registers of H' are in
chip_smoke.py's build report), and H' at each chunk width and ring depth
that fits.

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


PARENT_LOGS = {}   # the ptxas report of each parent build, by library


def build_parent(parent: str, source: str, flags=()) -> ctypes.CDLL:
    """The parent's csrc/`source` built (with extra nvcc `flags`) into this
    tree's build directory."""
    from featurebase_tpu_torch.ops import build
    src = os.path.join(parent, "featurebase_tpu_torch", "csrc", source)
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    tag = "".join(f.replace("-D", "_") for f in flags).lower()
    out = os.path.join(build.BUILD_DIR,
                       f"libparent_{os.path.splitext(source)[0]}{tag}.so")
    if out in PARENT_LOGS:
        return ctypes.CDLL(out)
    done = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, *flags,
                           "-o", out, src], check=True, capture_output=True,
                          text=True)
    PARENT_LOGS[out] = done.stdout + done.stderr
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


class ParentMoments:
    """The parent's kernel H through its C interface, sliced into the
    programs' outputs as the parent's wrappers sliced its (K, K) product."""

    def __init__(self, lib: ctypes.CDLL):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pi64, pi32 = ctypes.POINTER(i64), ctypes.POINTER(i32)
        lib.fb_group_product_slots.argtypes = [pi32, i64, pi64, pi32, pi32]
        lib.fb_group_product.argtypes = [pi32, i64, vp, vp, vp, i64, vp, i32,
                                         vp]
        lib.fb_group_product_slots.restype = i32
        lib.fb_group_product.restype = i32
        self.lib = lib
        self.tickets = torch.zeros(1024, dtype=torch.int32, device="cuda")

    def spec(self, table: np.ndarray, W: int, depths, filtered: bool):
        S, P = table.shape
        vec = 4 if W % 4 == 0 and not (table % np.uint64(16)).any() else 1
        x0 = int(filtered)
        return (ctypes.c_int * 15)(
            2, vec, S, P, len(depths), depths[0], depths[-1], 0, x0,
            x0 + depths[0] + 2, 0, 0 if filtered else -1, 0, 0, 0)

    def plan(self, spec, W: int):
        """(slot words, tickets, chunk words) of the parent's launch."""
        n, runs, cw = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
        rc = self.lib.fb_group_product_slots(spec, W, ctypes.byref(n),
                                             ctypes.byref(runs),
                                             ctypes.byref(cw))
        if rc:
            raise RuntimeError(f"parent moments plan: CUDA error {rc}")
        return n.value, runs.value, cw.value

    def product(self, table: np.ndarray, W: int, depths,
                filtered: bool) -> torch.Tensor:
        spec = self.spec(table, W, depths, filtered)
        K = sum(2 * d + 1 for d in depths)
        n_slots = self.plan(spec, W)[0]
        dev_table = torch.from_numpy(table.view(np.int64)).cuda()
        out = torch.zeros((K, K), dtype=torch.int64, device="cuda")
        slots = torch.empty(n_slots, dtype=torch.int64, device="cuda")
        rc = self.lib.fb_group_product(
            spec, W, dev_table.data_ptr(), out.data_ptr(), slots.data_ptr(),
            slots.numel(), self.tickets.data_ptr(), self.tickets.numel(),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"parent moments: CUDA error {rc}")
        return out

    @staticmethod
    def parts(m: torch.Tensor, depths):
        if len(depths) == 1:
            D = depths[0]
            e = 2 * D
            return m[e, e], m[:D, e], m[D:e, e], m[:D, :D] + m[D:e, D:e]
        Dx, Dy = depths
        ex, y0 = 2 * Dx, 2 * Dx + 1
        ey = y0 + 2 * Dy
        xp, xn = slice(0, Dx), slice(Dx, ex)
        yp, yn = slice(y0, y0 + Dy), slice(y0 + Dy, ey)
        return (m[ex, ex], m[xp, ex], m[xn, ex], m[yp, ey], m[yn, ey],
                m[xp, xp] + m[xn, xn], m[yp, yp] + m[yn, yn],
                m[xp, yp], m[xp, yn], m[xn, yp], m[xn, yn])


def flat(parts) -> torch.Tensor:
    return torch.cat([torch.as_tensor(p).reshape(-1) for p in parts])


def moments_tables(groups, f):
    """The address table of a stacked launch (the filter's column, then
    each group's planes) and the depths."""
    from featurebase_tpu_torch.ops import cuda_kernels as ck
    S, _, W = groups[0].shape
    cols = [ck._filter_addrs(f, S, W)] + [ck._stacked_addrs(g)
                                          for g in groups]
    return np.ascontiguousarray(np.concatenate(cols, axis=1)), \
        [g.shape[1] - 2 for g in groups]


def moments_cases(parent: str):
    """The first kernel H of the parent beside H': name -> (parent, change,
    plain, bytes), and the parent's launches a call where more than one
    (none: both launch once a Var or a Corr)."""
    import chip_smoke as c
    from featurebase_tpu_torch.ops import bsi as bsiops
    from featurebase_tpu_torch.ops import cuda_kernels as ck

    old = ParentMoments(build_parent(parent, ck.GROUP_SOURCE))
    rng = np.random.default_rng(61)
    W = 32768
    f128 = c.rand_words(rng, (128, W))
    x14, y12 = c.rand_words(rng, (128, 16, W)), c.rand_words(rng, (128, 14, W))
    x31, y31 = c.rand_words(rng, (128, 33, W)), c.rand_words(rng, (128, 33, W))
    cases = {}

    def add(name, groups, f, new, plain, nbytes):
        table, depths = moments_tables(groups, f)

        def parent_fn():
            return flat(old.parts(old.product(table, W, depths, True),
                                  depths))
        cases[name] = (parent_fn, lambda: flat(new()), lambda: flat(plain()),
                       nbytes)
    for S in (128, 1):
        gx, gy, f = x14[:S], y12[:S], f128[:S]
        add(f"var_moments/s{S}_d14", [gx], f,
            lambda gx=gx, f=f: ck.var_moments(gx, f),
            lambda gx=gx, f=f: bsiops.var_moments_plain(gx, f),
            17 * S * W * 4 + 15 * 16 * 8)
        add(f"corr_moments/s{S}_d14x12", [gx, gy], f,
            lambda gx=gx, gy=gy, f=f: ck.corr_moments(gx, gy, f),
            lambda gx=gx, gy=gy, f=f: bsiops.corr_moments_plain(gx, gy, f),
            31 * S * W * 4 + 43 * 45 * 8)
    # 128 shards' mirrors: the sharded wrappers; the parent over the same
    # addresses, one launch
    mx, my = [g.clone() for g in x14], [g.clone() for g in y12]
    rows = [r.clone() for r in f128]
    slots_x = np.tile(np.arange(16), (128, 1))
    slots_y = np.tile(np.arange(14), (128, 1))

    def mirror_table(groups):
        cols = [ck._filter_addrs(rows, 128, W)] + [
            ck._dim_addrs(ms, sl, W, "group") for ms, sl in groups]
        return np.ascontiguousarray(np.concatenate(cols, axis=1))
    for name, groups, depths, new, plain, nrows, cells in (
            ("var_moments/mirrors_s128_d14", [(mx, slots_x)], [14],
             lambda: ck.var_moments_sharded(mx, rows),
             lambda: bsiops.var_moments_plain(x14, f128), 17, 15 * 16),
            ("corr_moments/mirrors_s128_d14x12",
             [(mx, slots_x), (my, slots_y)], [14, 12],
             lambda: ck.corr_moments_sharded(mx, my, rows),
             lambda: bsiops.corr_moments_plain(x14, y12, f128), 31,
             43 * 45)):
        table = mirror_table(groups)

        def parent_fn(table=table, depths=depths):
            return flat(old.parts(old.product(table, W, depths, True),
                                  depths))
        cases[name] = (parent_fn, lambda new=new: flat(new()),
                       lambda plain=plain: flat(plain()),
                       nrows * 128 * W * 4 + cells * 8)
    add("var_moments/s128_d31", [x31], f128,
        lambda: ck.var_moments(x31, f128),
        lambda: bsiops.var_moments_plain(x31, f128),
        34 * 128 * W * 4 + 32 * 33 * 8)
    add("corr_moments/s128_d31x31", [x31, y31], f128,
        lambda: ck.corr_moments(x31, y31, f128),
        lambda: bsiops.corr_moments_plain(x31, y31, f128),
        67 * 128 * W * 4 + 95 * 96 * 8)
    return cases, {}


def resident_blocks(regs: int, smem: int) -> int:
    """Blocks of 256 threads an H100 SM holds at `regs` registers a thread
    (allocated in units of 8 a thread) and `smem` dynamic shared bytes a
    block (1 KB reserved a block; 228 KB an SM; 65,536 registers)."""
    by_regs = 65536 // (256 * (-(-regs // 8) * 8))
    by_smem = (228 * 1024) // (smem + 1024)
    return min(by_regs, by_smem, 8)


def moments_ablation(parent: str, reps: int) -> None:
    """At S = 128, Var of depth 14 and Corr of depths 14 and 12: the
    parent's H and H' under their ablation builds (copies alone, product
    alone), the parent's form (registers from ptxas, resident blocks an
    SM) and the plan of H', and H' at every chunk width and ring depth that
    fits.  Device times only (the ablation builds give wrong counts)."""
    import chip_smoke as c
    from featurebase_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.default_rng(67)
    W = 32768
    f = c.rand_words(rng, (128, W))
    gx, gy = c.rand_words(rng, (128, 16, W)), c.rand_words(rng, (128, 14, W))
    shapes = {"var_moments/s128_d14": [gx], "corr_moments/s128_d14x12":
              [gx, gy]}
    flags = {"kernel": (), "copy_only": ("-DFB_ABLATE_COMPUTE",),
             "compute_only": ("-DFB_ABLATE_COPY",)}
    parents = {k: ParentMoments(build_parent(parent, ck.GROUP_SOURCE, fl))
               for k, fl in flags.items()}
    real = ck._moments_lib
    out = {}
    try:
        for name, groups in shapes.items():
            table, depths = moments_tables(groups, f)
            kernel = ck.var_moments if len(groups) == 1 else ck.corr_moments
            row = out.setdefault(name, {})
            for k, fl in flags.items():
                dev = c.kernel_device_ms(
                    lambda p=parents[k]: p.product(table, W, depths, True),
                    reps)
                row[f"parent_{k}"] = sum(v for key, v in dev.items()
                                         if key.startswith("moments"))
                ck._moments_lib = lambda flags=(), fl=fl: real(fl)
                dev = c.kernel_device_ms(lambda: kernel(*groups, f), reps)
                row[f"change_{k}"] = sum(v for key, v in dev.items()
                                         if key.startswith("moments"))
                ck._moments_lib = real
            # the parent's form: its registers from ptxas, its shared bytes
            # from its plan (2 stages of the staged and formed rows)
            spec = parents["kernel"].spec(table, W, depths, True)
            cw = parents["kernel"].plan(spec, W)[2]
            K = sum(2 * d + 1 for d in depths)
            mt = 1 if K <= 16 else 2 if K <= 32 else 4
            nt = 1 if K <= 8 else 4
            staged = 1 + sum(d + 2 for d in depths) + 1 + 1 + 2 * len(depths)
            smem = max(2 * staged * (cw + 4) * 4, 8 * 16 * mt * 8 * nt * 4)
            sym = f"moments_kernelILi{mt}ELi{nt}ELi4E"
            regs = [r["registers"] for lib, log in PARENT_LOGS.items()
                    if lib.endswith("group_kernels.so")
                    for fn, r in c.ptxas_report(log).items()
                    if fn.startswith(sym)]
            row["parent_form"] = dict(
                mt=mt, nt=nt, chunk_words=cw, smem_bytes=smem,
                regions=-(-K // (16 * mt)) * -(-K // (8 * nt)),
                registers=regs[0] if regs else None,
                blocks_per_sm=resident_blocks(regs[0], smem) if regs
                else None)
            row["change_form"] = ck.moments_plan(
                ck._moments_spec(table, W, depths, True), W)
            # H' at each chunk width and ring depth that fits
            sweep = {}
            for cw in (256, 128, 64):
                for st in (2, 3, 4, 6, 8):
                    if st * (table.shape[1] + 2) * (cw + 8) * 4 > 227 * 1024:
                        continue
                    spec = ck._moments_spec(table, W, depths, True, cw, st)
                    p = ck.moments_plan(spec, W)
                    o = torch.zeros((p["R"], p["C"]), dtype=torch.int64,
                                    device="cuda")
                    dev = c.kernel_device_ms(
                        lambda spec=spec, o=o: ck._run_moments(
                            kernel, spec, table, W, o), reps)
                    sweep[f"cw{cw}_st{st}"] = dict(
                        device_ms=sum(v for key, v in dev.items()
                                      if key.startswith("moments")),
                        blocks_per_sm=p["blocks_per_sm"], grid=p["grid"])
            row["change_sweep"] = sweep
            print(json.dumps({"ablation": name, **row}), flush=True)
    finally:
        ck._moments_lib = real


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("--kernels", choices=("bsi", "rows", "decode", "moments"),
                    default="bsi")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_parent: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as c

    make = {"bsi": bsi_cases, "rows": rows_cases, "decode": decode_cases,
            "moments": moments_cases}[args.kernels]
    cases, calls = make(args.parent)
    timer = c.Timer(args.reps)
    prefixes = ("row_counts", "percentile", "bsi_sum_planes", "bsi_min_max",
                "bsi_decode", "moments")
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
    if args.kernels == "moments":
        moments_ablation(args.parent, args.reps)
    print(c.card_line())
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
