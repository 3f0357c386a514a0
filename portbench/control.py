"""The control of the comparison that decides `correct`: the plain
reference put in the program's place, with its counts and sums carried in
float32 instead of int64 (the configurations state exact answers; float32
is the narrower type a faster path would be tempted to accumulate in).
Its answers go through the same check as the program's and must fail it.

    python3 -m portbench.control --workload <name> --seeds <n> [<n> ...]

For each seed it takes the queries that the cell's clients would keep for
the check among their first --per-client queries, works out the exact and
the float32 answers from the seed's columns on the card, a chunk of shards
at a time, and prints one JSON line with the checks' readings.  It never
runs the program; the benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from typing import List, Optional

import torch

from portbench import compare, datagen, spec, traffic
from portbench.reference.answers import Reference


class _Kept:
    """A record of the check (compare.checks reads .answer, .query,
    .error)."""

    def __init__(self, query, answer):
        self.query, self.answer, self.error = query, answer, None


def control_readings(cfg: dict, mix: dict, seed: int, device,
                     per_client: int = 400) -> dict:
    kept = [q for c in range(int(mix["clients"]))
            for q in itertools.islice(traffic.stream(mix, cfg, seed, c),
                                      per_client) if q.check]
    specs = sorted({q.spec for q in kept})
    queries = [traffic.thaw(s) for s in specs]
    exact = Reference(cfg, queries, torch.int64)
    narrow = Reference(cfg, queries, torch.float32)
    t = time.perf_counter()
    for _, _, _, cols in datagen.iter_chunks(cfg, seed, device):
        exact.add(cols)
        narrow.add(cols)
    ref = {s: compare.reference_form(q, a)
           for s, q, a in zip(specs, queries, exact.answers())}
    ctl = {s: compare.reference_form(q, a)
           for s, q, a in zip(specs, queries, narrow.answers())}
    checks = compare.checks([_Kept(q, ctl[q.spec]) for q in kept], ref)
    return {"seed": seed, "seconds": time.perf_counter() - t,
            "distinct_queries": len(specs),
            "checks": {c["name"]: c["value"] for c in checks},
            "correct": all(compare.passed(c) for c in checks)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--per-client", type=int, default=400)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    _, cfg, mix = spec.cell(spec.benchmark(), args.workload)
    for seed in args.seeds:
        print(json.dumps(dict(control_readings(
            cfg, mix, seed, torch.device("cuda", 0), args.per_client),
            workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
