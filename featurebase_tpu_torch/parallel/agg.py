"""Mesh aggregation: a kernel launch on each member's block, one merge.

Counterpart of featurebase_tpu/parallel/agg.py, whose programs are
shard_map + psum over the "shards" axis (reference: executor.go:6449
mapReduce streams per-shard partials over HTTP and merges them at the
coordinator).  Here every operand is a ``Sharded`` array (parallel/mesh.py):
each program launches the port's kernel once on each local member's block,
on that member's device (ops/cuda_kernels.py; the plain versions on CPU
members), and merges the int64 partials with one ``_psum``: summed on the
first local member's device, then all-reduced across processes when the
mesh spans them (parallel/multihost.py).  Members are launched from one
thread, in turn: a launch is asynchronous, so members on distinct cards
still overlap, and the kernels' per-device caches are not shared between
threads.

    total_count   kernel A with its count reduce
    row_counts    kernel B', stacked
    pair_counts   kernel E', stacked
    sum_planes    kernel C'
    group_sums    kernel F'
    gather_and, mask_filter, take_rows
                  torch ops, shard-local, returning Sharded arrays

Counts are int64 (uint32 in the JAX package: its parity totals stay below
2^32).  The merges of the families that the JAX package runs on a mesh
through GSPMD with no program here (Min/Max, Percentile's rounds, Var and
Corr) follow the eight programs, and ``finalize_sum`` finishes a Sum on
the host.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from featurebase_tpu_torch.ops import bitwise as bw
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.parallel.mesh import Mesh, Sharded
from featurebase_tpu_torch.parallel.multihost import all_gather, all_reduce


def _psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The local members' int64 partials summed on the first local member's
    device, then summed across the mesh's processes."""
    dev = parts[0].device
    total = parts[0].to(torch.int64)
    for p in parts[1:]:
        total = total + p.to(dev, torch.int64)
    return all_reduce(mesh, total, "sum")


def _index(ix, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ix, dtype=np.int64), device=dev)


# -- Count(expr): total popcount over all shards ----------------------------

def total_count(mesh: Mesh, words: Sharded) -> int:
    """Global popcount of a sharded (S, W) stack -> int."""
    return int(_psum(mesh, [bw.popcount(b) for b in words.blocks]))


# -- per-row counts (TopN / Rows / Distinct-set; reference fragment.top
# fragment.go:1317 + Pairs.Add coordinator merge) ---------------------------

def row_counts(mesh: Mesh, tiles: Sharded, filt) -> torch.Tensor:
    """Global per-row filtered counts: (S, R, W) x (S, W) -> (R,) int64
    (`filt` None counts the rows unfiltered)."""
    return _psum(mesh, [
        ck.row_counts(t.contiguous(),
                      None if filt is None else filt.blocks[k].contiguous()
                      ).sum(0)
        for k, t in enumerate(tiles.blocks)])


# -- GroupBy frontier expansion (reference groupByIterator executor.go:8617
# + mergeGroupCounts:3728, here one merge per level) -------------------------

def pair_counts(mesh: Mesh, masks: Sharded, tile: Sharded) -> torch.Tensor:
    """Global cross-product counts: (S, F, W) x (S, R, W) -> (F, R)."""
    return _psum(mesh, [ck.pair_counts(m.contiguous(), t.contiguous())
                        for m, t in zip(masks.blocks, tile.blocks)])


def gather_and(mesh: Mesh, masks: Sharded, tile: Sharded, fi, rj) -> Sharded:
    """Materialize surviving combinations shard-locally: -> (S, K, W)."""
    return masks.map(lambda m, t: m[:, _index(fi, m.device)]
                     & t[:, _index(rj, t.device)], tile)


def mask_filter(mesh: Mesh, tiles: Sharded, filt: Sharded) -> Sharded:
    """(S, R, W) & (S, W) -> (S, R, W), shard-local."""
    return tiles.map(lambda t, f: t & f[:, None, :], filt)


def take_rows(mesh: Mesh, masks: Sharded, keep) -> Sharded:
    """(S, F, W) -> (S, K, W) keeping the given frontier indices."""
    return masks.map(lambda m: m[:, _index(keep, m.device)])


# -- BSI aggregates (reference fragment.sum:724 via BitmapBSICountFilter) ----

def sum_planes(mesh: Mesh, bsi: Sharded, filt: Sharded
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Global Sum parts: (pos_pops (D,), neg_pops (D,), count) int64 from
    kernel C' on each block.  The host finishes sum = sum of 2^i (pos_i -
    neg_i) in exact Python ints (finalize_sum)."""
    parts = _psum(mesh, [ck.bsi_sum_planes(g, f) for g, f in
                         zip(bsi.blocks, filt.blocks)])
    D = (parts.numel() - 1) // 2
    return parts[:D], parts[D:2 * D], parts[2 * D]


def group_sums(mesh: Mesh, masks: Sharded, bsi: Sharded
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched GroupBy Sum aggregate from kernel F' on each block: (pos
    (G, D), neg (G, D), counts (G,)), counts the masks' columns with a
    value."""
    parts = _psum(mesh, [ck.bsi_sum_groups(g, m.contiguous())
                         for m, g in zip(masks.blocks, bsi.blocks)])
    D = (parts.shape[1] - 1) // 2
    return parts[:, :D], parts[:, D:2 * D], parts[:, 2 * D]


def finalize_sum(pos_pops, neg_pops) -> int:
    """Exact sum of 2^i (pos_i - neg_i) over per-plane popcounts, in
    Python ints (reference agg.py:179)."""
    pp = np.asarray(pos_pops).astype(np.int64)
    nn = np.asarray(neg_pops).astype(np.int64)
    return sum((1 << i) * (int(pp[i]) - int(nn[i])) for i in range(pp.size))


# -- the families the JAX package runs on a mesh through GSPMD --------------

def min_max_parts(mesh: Mesh, bsi: Sharded, filt: Sharded, is_min: bool
                  ) -> torch.Tensor:
    """Kernel D' on each block -> (S_pad, 4, 2) int64 per-shard descents in
    layout order (every process's blocks), for min_max_stacked_finish."""
    local = torch.cat([ck.bsi_min_max(g, f, is_min).cpu()
                       for g, f in zip(bsi.blocks, filt.blocks)])
    return all_gather(mesh, local)


def moments(mesh: Mesh, parts: List[Sequence[torch.Tensor]]
            ) -> List[torch.Tensor]:
    """Kernel H''s raw counts of each member (the outputs of var_moments or
    corr_moments), each output added over the members and processes."""
    return [_psum(mesh, [p[i] for p in parts]) for i in range(len(parts[0]))]


def percentile_counts(mesh: Mesh, vals: Sharded, exists: Sharded,
                      filt: Sharded, base: int, thresholds) -> torch.Tensor:
    """Kernel I' on each block, merged: the bins added, the min of the
    minima and the max of the maxima (decode.percentile's `counts`)."""
    parts = [ck.percentile_counts(v, e, f, base, thresholds)
             for v, e, f in zip(vals.blocks, exists.blocks, filt.blocks)]
    nb = parts[0].numel() - 2
    bins = _psum(mesh, [p[:nb] for p in parts])
    dev = bins.device
    mn = all_reduce(mesh, torch.stack([p[nb].to(dev) for p in parts]).min()
                    .reshape(1), "min")
    mx = all_reduce(mesh, torch.stack([p[nb + 1].to(dev) for p in parts])
                    .max().reshape(1), "max")
    return torch.cat([bins, mn, mx])
