"""One process of the port's multi-process mesh test
(tests/test_torch_multihost.py; also run by chip_smoke.py's mesh phase).

Usage: torch_multihost_worker.py PORT RANK [--processes 2] [--members 4]
[--device cpu] [--backend gloo]

The processes join one torch.distributed group over TCP on localhost and
form one "shards" mesh of processes x members, process by process.  Host
masters are owner-placed (parallel/placement.py): every process receives
the same write stream, but stores host fragments only for the shards it
owns by the jump-hash placement, and keeps the shard and row ids of the
others as metadata.  The stacked mesh arrays are laid out so that each
process's owned shards sit at its member blocks, and every aggregate is
merged across the processes.  The asserts are the JAX worker's
(tests/multihost_worker.py) against numpy, and more: Min/Max, Var, BSI
Distinct and Sort merged across processes, and a bitmap result, which
needs every member's block, raising.  The port has no host-memory
accounting yet, so each process reports its fragments' host word bytes.
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("port")
    ap.add_argument("rank", type=int)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--members", type=int, default=4)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    pid = args.rank
    import numpy as np
    import torch
    torch.set_num_threads(1)

    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    from featurebase_tpu_torch.executor.executor import Executor
    from featurebase_tpu_torch.model.field import FieldOptions
    from featurebase_tpu_torch.model.fragment import Fragment
    from featurebase_tpu_torch.model.index import Holder
    from featurebase_tpu_torch.parallel import multihost, placement

    multihost.initialize(f"localhost:{args.port}", args.processes, pid,
                         args.backend)
    mesh = multihost.global_mesh(args.members, args.device)
    assert mesh.size == args.processes * args.members
    assert mesh.local == list(range(pid * args.members,
                                    (pid + 1) * args.members))
    placement.configure(n_processes=args.processes, process_id=pid)
    holder = Holder()
    idx = holder.create_index("mh")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", FieldOptions(type="int", min=-100, max=10000))

    rng = np.random.default_rng(42)  # same seed every process
    n = 5000
    cols = np.sort(rng.choice(16 * SHARD_WIDTH, size=n, replace=False))
    fr = rng.integers(0, 4, size=n)
    gr = rng.integers(0, 3, size=n)
    vv = rng.integers(-100, 10000, size=n)
    idx.field("f").import_bits(fr, cols)
    idx.field("g").import_bits(gr, cols)
    idx.field("v").import_values(cols, vv)
    idx.mark_exists(cols)

    ex = Executor(holder, mesh=mesh)

    # the stacked blocks read host fragments only for this process's shards
    touched = set()
    real_host_row = Fragment.host_row

    def spy(self, row):
        touched.add(self.shard)
        return real_host_row(self, row)
    Fragment.host_row = spy
    (count,) = ex.execute("mh", "Count(Row(f=1))")
    assert count == int((fr == 1).sum()), count
    Fragment.host_row = real_host_row
    owned = {s for s in range(16) if placement.owns("mh", s)}
    assert touched and touched <= owned, (pid, sorted(touched), owned)

    # host storage is owner-scoped too; the shard set stays global
    held = {sh for f in idx.fields.values()
            for v in f.views.values() for sh in v.fragments}
    assert held and held <= owned, (pid, sorted(held), sorted(owned))
    assert set(idx.available_shards()) == set(range(16))
    nbytes = sum(fg._words.nbytes for f in idx.fields.values()
                 for v in f.views.values() for fg in v.fragments.values())
    print(f"MULTIHOST_BYTES {pid} {nbytes} {len(owned)}", flush=True)

    (sum_vc,) = ex.execute("mh", "Sum(field=v)")
    assert sum_vc.val == int(vv.sum()), (sum_vc.val, int(vv.sum()))
    assert sum_vc.count == n

    (topn,) = ex.execute("mh", "TopN(f)")
    want = sorted(((int((fr == r).sum()), int(r)) for r in np.unique(fr)),
                  key=lambda t: (-t[0], t[1]))
    got = [(p.count, p.id) for p in topn.pairs]
    assert got == want, (got, want)

    (groups,) = ex.execute("mh", "GroupBy(Rows(f), Rows(g))")
    got_g = {tuple(x.row_id for x in gc.group): gc.count for gc in groups}
    keys, counts = np.unique(np.stack([fr, gr], axis=1), axis=0,
                             return_counts=True)
    want_g = {tuple(int(v) for v in k): int(c)
              for k, c in zip(keys, counts)}
    assert got_g == want_g

    (gsum,) = ex.execute("mh", "GroupBy(Rows(g), aggregate=Sum(field=v))")
    got_s = {gc.group[0].row_id: (gc.count, gc.agg) for gc in gsum}
    want_s = {int(r): (int((gr == r).sum()), int(vv[gr == r].sum()))
              for r in np.unique(gr)}
    assert got_s == want_s, (got_s, want_s)

    (dis,) = ex.execute("mh", "Distinct(field=g)")
    assert list(dis.columns()) == sorted(int(r) for r in np.unique(gr))

    # merges of the families without an agg program, across processes
    for call, pick in (("Min", np.min), ("Max", np.max)):
        (vc,) = ex.execute("mh", f"{call}(field=v)")
        ext = int(pick(vv))
        assert (vc.val, vc.count) == (ext, int((vv == ext).sum())), call
    (var,) = ex.execute("mh", "Var(field=v)")
    tot, tot_sq = int(vv.sum()), int((vv.astype(np.int64) ** 2).sum())
    mean = tot / n
    assert var == round(max(tot_sq / n - mean * mean, 0.0), 6), var
    (disv,) = ex.execute("mh", "Distinct(Row(g=1), field=v)")
    assert [int(x) for x in disv.values()] == \
        [int(x) for x in np.unique(vv[gr == 1])]
    (srt,) = ex.execute("mh", "Sort(All(), field=v, limit=5)")
    order = np.lexsort((cols, vv))[:5]
    assert srt["columns"] == [int(c) for c in cols[order]], srt
    assert srt["values"] == [int(x) for x in vv[order]], srt

    # a bitmap result needs every member's block: it raises
    try:
        ex.execute("mh", "Row(f=1)")
    except RuntimeError as e:
        assert "spans processes" in str(e), e
    else:
        raise AssertionError("Row(f=1) answered on a mesh over processes")
    multihost.shutdown()
    print(f"MULTIHOST_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
