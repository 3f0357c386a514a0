"""Host time of the BSI import, sparse and dense, on the host's CPU.

    python3 featurebase_tpu_torch/tools/time_bsi_import.py [--tree ROOT] \
        [--reps 5]

Times ``Field.import_values`` of the ``featurebase_tpu_torch`` found under
ROOT (by default the checkout that holds this script), so that an earlier
commit unpacked beside it (``git archive <rev> | tar -x -C DIR``) is timed
by the same code.  Two batches, values drawn in [-1000, 10000) as
chip_smoke.py's field v: "sparse", 4 columns a shard over 128 shards (a
small client batch), and "dense", 625,000 columns a shard (chip_smoke.py's
table) over 8 shards.  Each run imports into a new index.  Also times
``Field._bsi_delta`` alone on one shard of each.  No device is used.
Prints one JSON object: the median seconds of each over ``--reps`` runs.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

SHARD_WIDTH = 1 << 20
BATCHES = {"sparse": (128, 4), "dense": (8, 625_000)}


def batch(shards: int, per_shard: int, seed: int = 0):
    """(columns, values) of `per_shard` distinct sorted columns a shard."""
    rng = np.random.default_rng(seed)
    cols = np.concatenate([
        s * SHARD_WIDTH + np.sort(rng.choice(SHARD_WIDTH, per_shard,
                                             replace=False))
        for s in range(shards)]).astype(np.int64)
    return cols, rng.integers(-1000, 10000, size=cols.size)


def median_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    from featurebase_tpu_torch.model.field import Field, FieldOptions
    from featurebase_tpu_torch.model.index import Holder

    out = {"tree": os.path.abspath(args.tree), "reps": args.reps,
           "cpus": os.cpu_count()}
    for name, (shards, per_shard) in BATCHES.items():
        cols, vals = batch(shards, per_shard)

        def run():
            idx = Holder().create_index("t")
            idx.create_field("v", FieldOptions(type="int", min=-1000,
                                               max=10000))
            idx.field("v").import_values(cols, vals)

        run()
        out[f"{name}_import_s"] = median_s(run, args.reps)
        c = cols[:per_shard] % SHARD_WIDTH
        v = vals[:per_shard]
        mg = np.abs(v).astype(np.uint64)
        out[f"{name}_delta_one_shard_s"] = median_s(
            lambda: Field._bsi_delta(c, v, mg, 14), args.reps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
