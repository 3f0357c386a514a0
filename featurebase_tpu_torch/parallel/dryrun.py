"""One sharded query step over a mesh, and the engine over the same mesh.

Counterpart of ``dryrun_multichip`` in the JAX package's __graft_entry__.py
(that one stays the JAX reference).  ``dryrun_multichip(n)`` builds an
n-member "shards" mesh (parallel/mesh.py; `devices` names the members, and
may repeat one card or name CPU members) and runs:

1. the flagship step with its operands Sharded over the mesh: Count of an
   intersection (kernel A's count reduce, total_count), a BSI range row
   under that intersection (kernel A, one launch a member), the range's
   Sum parts (kernel C', sum_planes) and per-row TopN counts (kernel B',
   row_counts), each merged once and held against numpy;
2. the engine, ``Executor(holder, mesh=...)``, on n + 3 shards (not a
   multiple of n, so the stacked arrays are padded and the members hold
   different loads), with the JAX dry run's writes and asserts: Count,
   Sum, Min/Max, TopN, GroupBy(+Sum), Rows, Distinct on a set and a BSI
   field, Sort, Percentile, Extract, and Count and Extract on a keyed
   index.
"""
from __future__ import annotations

import numpy as np
import torch

from featurebase_tpu_torch.core.consts import SHARD_WIDTH, WORDS_PER_ROW
from featurebase_tpu_torch.parallel import agg
from featurebase_tpu_torch.parallel.mesh import Mesh, make_mesh

FLAGSHIP_DEPTH = 16
FLAGSHIP_PRED = 5


def example_args(S: int = 2, R: int = 8, D: int = FLAGSHIP_DEPTH,
                 seed: int = 0):
    """The flagship step's host operands, random words from a seed: rows a
    and b (S, W), a TopN tile (S, R, W) and a BSI group (S, D + 2, W)."""
    rng = np.random.default_rng(seed)
    W = WORDS_PER_ROW

    def bits(*shape):
        return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
            .astype(np.uint32)
    return bits(S, W), bits(S, W), bits(S, R, W), bits(S, D + 2, W)


def _bits(words: np.ndarray) -> np.ndarray:
    """(..., W) uint32 words -> (..., 32 W) bools, column order."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         axis=-1, bitorder="little").astype(bool)


def flagship_oracle(row_a, row_b, topn, bsi, pred: int = FLAGSHIP_PRED):
    """numpy answers of the flagship step: (count, plane_pops (D,), topn
    counts (R,)) over every shard."""
    inter = _bits(row_a & row_b)
    D = bsi.shape[1] - 2
    mag = np.zeros(inter.shape, dtype=np.int64)
    for i in range(D):
        mag |= _bits(bsi[:, 2 + i]).astype(np.int64) << i
    val = np.where(_bits(bsi[:, 1]), -mag, mag)
    rng_row = _bits(bsi[:, 0]) & inter & (val > pred)
    plane_pops = np.array([(_bits(bsi[:, 2 + i]) & rng_row).sum()
                           for i in range(D)], dtype=np.int64)
    counts = np.array([(_bits(topn[:, r]) & inter).sum()
                       for r in range(topn.shape[1])], dtype=np.int64)
    return int(inter.sum()), plane_pops, counts


def flagship_step(mesh: Mesh, row_a, row_b, topn, bsi,
                  pred: int = FLAGSHIP_PRED):
    """The flagship step over Sharded operands: (count, plane_pops (D,),
    topn counts (R,)), each merged once over the mesh."""
    from featurebase_tpu_torch.ops import bsi_traced as bst
    from featurebase_tpu_torch.ops import lowering
    D = bsi.blocks[0].shape[1] - 2
    inter = row_a.map(lambda a, b: a & b, row_b)
    count = agg.total_count(mesh, inter)
    pred_bits, pred_neg = bst.encode_pred(pred, D)

    def range_row(g, f):
        e = ("and", bst.expr_gt(bst.LeafPlanes("bsi", g), pred_bits,
                                int(pred_neg), D, False),
             ("plane", "inter", f))
        return lowering.run_words(e, g.shape[0], g.shape[2])
    rng_row = bsi.map(range_row, inter)
    pos, neg, _ = agg.sum_planes(mesh, bsi, rng_row)
    counts = agg.row_counts(mesh, topn, inter)
    return count, (pos + neg).cpu().numpy(), counts.cpu().numpy()


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """Run the flagship step and the engine over an n-member mesh (see the
    module docstring); raises AssertionError on a wrong answer.  Returns the
    line it prints."""
    mesh = make_mesh(n_devices, devices)
    S = max(n_devices, 2)
    host = example_args(S=S)
    count, pops, topn = flagship_step(mesh, *(mesh.put(a) for a in host))
    want = flagship_oracle(*host)
    assert count == want[0], (count, want[0])
    assert np.array_equal(pops, want[1]), (pops, want[1])
    assert np.array_equal(topn, want[2]), (topn, want[2])

    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.model.field import FieldOptions
    from featurebase_tpu_torch.model.index import Holder, IndexOptions
    holder = Holder()
    idx = holder.create_index("dryrun")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("n", FieldOptions(type="int", min=0, max=1000))
    ex = Executor(holder, mesh=mesh)
    ns = n_devices + 3
    for s in range(ns):
        ex.execute("dryrun", f"Set({s * SHARD_WIDTH + 1}, f=1)")
        ex.execute("dryrun", f"Set({s * SHARD_WIDTH + 2}, f=2)")
        ex.execute("dryrun", f"Set({s * SHARD_WIDTH + 1}, g={s % 2})")
        ex.execute("dryrun", f"Set({s * SHARD_WIDTH + 2}, g={s % 2})")
        ex.execute("dryrun", f"Set({s * SHARD_WIDTH + 1}, n={s + 1})")
    tri = ns * (ns + 1) // 2
    families = []
    (count,) = ex.execute("dryrun", "Count(Intersect(Row(f=1), Row(n > 0)))")
    assert count == ns, count
    families.append("Count")
    (sum_vc,) = ex.execute("dryrun", "Sum(field=n)")
    assert sum_vc.val == tri, sum_vc.val
    families.append("Sum")
    (mn,) = ex.execute("dryrun", "Min(field=n)")
    assert (mn.val, mn.count) == (1, 1), (mn.val, mn.count)
    (mx,) = ex.execute("dryrun", "Max(field=n)")
    assert (mx.val, mx.count) == (ns, 1), (mx.val, mx.count)
    families.append("Min/Max")
    (topn_r,) = ex.execute("dryrun", "TopN(f)")
    assert [(p.id, p.count) for p in topn_r.pairs] == \
        [(1, ns), (2, ns)], topn_r.pairs
    families.append("TopN")
    (groups,) = ex.execute("dryrun", "GroupBy(Rows(f), Rows(g))")
    got = {tuple(fr.row_id for fr in gc.group): gc.count for gc in groups}
    assert got[(1, 0)] + got.get((1, 1), 0) == ns, got
    (gsum,) = ex.execute(
        "dryrun", "GroupBy(Rows(f), aggregate=Sum(field=n))")
    agg_by_row = {gc.group[0].row_id: gc.agg for gc in gsum}
    assert agg_by_row[1] == tri, agg_by_row
    families.append("GroupBy(+Sum)")
    (rows_r,) = ex.execute("dryrun", "Rows(f)")
    assert list(rows_r) == [1, 2], rows_r
    families.append("Rows")
    (dis,) = ex.execute("dryrun", "Distinct(field=g)")
    want_rows = [0, 1] if ns > 1 else [0]
    assert list(dis.columns()) == want_rows, dis.columns()
    (disn,) = ex.execute("dryrun", "Distinct(field=n)")
    assert list(disn.values()) == list(range(1, ns + 1)), disn.values()
    families.append("Distinct(set+BSI)")
    (srt,) = ex.execute("dryrun", "Sort(All(), field=n, limit=3)")
    assert srt["values"] == [1, 2, 3], srt
    assert srt["columns"] == [s * SHARD_WIDTH + 1 for s in range(3)], srt
    families.append("Sort")
    (pct,) = ex.execute("dryrun", "Percentile(field=n, nth=50)")
    assert pct.val == (ns + 1) // 2, pct.val
    families.append("Percentile")
    (ext,) = ex.execute("dryrun", "Extract(Row(f=1), Rows(n))")
    assert len(ext.columns) == ns, len(ext.columns)
    assert ext.columns[0].column == 1 and ext.columns[0].rows == [1], \
        (ext.columns[0].column, ext.columns[0].rows)
    families.append("Extract")
    kidx = holder.create_index("dryk", IndexOptions(keys=True))
    kidx.create_field("kf")
    kmap = kidx.translate_store.create_keys(["alice", "bob", "carol"])
    kcols = np.array([kmap["alice"], kmap["bob"], kmap["carol"]])
    kidx.field("kf").import_bits(np.array([1, 1, 2]), kcols)
    kidx.mark_exists(kcols)
    (kcount,) = ex.execute("dryk", "Count(Row(kf=1))")
    assert kcount == 2, kcount
    (kext,) = ex.execute("dryk", "Extract(All(), Rows(kf))")
    assert sorted(c.column for c in kext.columns) == \
        ["alice", "bob", "carol"], [c.column for c in kext.columns]
    families.append("Keyed(Count+Extract)")
    if any(d.type == "cuda" for d in mesh.members):
        torch.cuda.synchronize()
    line = (f"dryrun_multichip({n_devices}): ok, members="
            f"{[str(d) for d in mesh.members]}, shards={ns} (uneven, padded "
            f"to {mesh.padded(ns)}), families asserted: {', '.join(families)}")
    print(line)
    return line
