"""Exact answers of structured queries (portbench/traffic.py) over
per-record columns, accumulated a chunk of records at a time.

Canonical answers: a GroupBy is {(row id, ...): (count, sum)} over its
non-empty groups (sum 0 without an aggregate); a Sum is (sum, count) of the
records that pass the filter and hold a value; a Count is the count.  With
acc=torch.int64 every number is exact; the control passes a narrower type.
"""
from __future__ import annotations

from typing import Dict, Iterable, List

import torch


def _rows(spec: dict) -> List[int]:
    rows = spec["rows"]
    if isinstance(rows, dict):
        return list(range(int(rows["from"]), int(rows["to"]) + 1))
    return [int(r) for r in rows]


def _mask(conds, cols, fcol, n, device):
    m = torch.ones(n, dtype=torch.bool, device=device)
    for c in conds or ():
        v = cols[fcol[c[1]]]
        if c[0] == "between":
            m &= (v >= int(c[2])) & (v <= int(c[3]))
        elif c[0] == "==":
            m &= v == int(c[2])
        elif c[0] == "<":
            m &= v < int(c[2])
        elif c[0] == "<=":
            m &= v <= int(c[2])
        elif c[0] == ">":
            m &= v > int(c[2])
        elif c[0] == ">=":
            m &= v >= int(c[2])
        else:
            raise ValueError(f"unknown condition {c[0]!r}")
    return m


class Reference:
    """Accumulates the answers of `queries` (dicts) over chunks of columns
    of the configuration `cfg`."""

    def __init__(self, cfg: dict, queries: List[dict],
                 acc: torch.dtype = torch.int64):
        self.cfg, self.queries, self.acc = cfg, queries, acc
        self.fspec = {f["field"]: f for f in cfg["fields"]}
        self.fcol = {f["field"]: f["col"] for f in cfg["fields"]}
        self.parts: List = [None] * len(queries)

    def _groupby(self, q, cols, n, device):
        dims = q["groupby"]
        key = torch.zeros(n, dtype=torch.int64, device=device)
        ok = _mask(q.get("filter"), cols, self.fcol, n, device)
        sizes = []
        for f in dims:
            rows = _rows(self.fspec[f])
            lo, hi = min(rows), max(rows)
            lut = torch.full((hi - lo + 1,), -1, dtype=torch.int64)
            lut[torch.tensor(rows) - lo] = torch.arange(len(rows))
            lut = lut.to(device)
            v = cols[self.fcol[f]]
            inside = (v >= lo) & (v <= hi)
            idx = lut[(v - lo).clamp(0, hi - lo)]
            ok &= inside & (idx >= 0)
            key = key * len(rows) + idx.clamp(min=0)
            sizes.append(len(rows))
        groups = 1
        for s in sizes:
            groups *= s
        key = key[ok]
        counts = torch.zeros(groups, dtype=self.acc, device=device)
        counts.index_add_(0, key, torch.ones(key.numel(), dtype=self.acc,
                                             device=device))
        sums = torch.zeros(groups, dtype=self.acc, device=device)
        if q.get("aggregate"):
            vals = cols[self.fcol[q["aggregate"]["sum"]]][ok]
            sums.index_add_(0, key, vals.to(self.acc))
        return torch.stack([counts, sums])

    def _sum(self, q, cols, n, device):
        m = _mask(q.get("filter"), cols, self.fcol, n, device)
        vals = cols[self.fcol[q["sum"]]]
        return torch.stack([vals.to(self.acc).mul(m).sum(dtype=self.acc),
                            m.sum(dtype=self.acc)])

    def _count(self, q, cols, n, device):
        return _mask(q["count"], cols, self.fcol, n, device) \
            .sum(dtype=self.acc)

    def add(self, cols: Dict[str, torch.Tensor]):
        """Fold one chunk of columns into every query's accumulators."""
        any_col = next(iter(cols.values()))
        n, device = any_col.numel(), any_col.device
        for i, q in enumerate(self.queries):
            if "groupby" in q:
                part = self._groupby(q, cols, n, device)
            elif "sum" in q:
                part = self._sum(q, cols, n, device)
            elif "count" in q:
                part = self._count(q, cols, n, device)
            else:
                raise ValueError(f"unknown query {q}")
            self.parts[i] = part if self.parts[i] is None \
                else self.parts[i] + part

    def answers(self) -> list:
        """The canonical answer of each query, as Python ints."""
        out = []
        for q, part in zip(self.queries, self.parts):
            if "groupby" in q:
                sizes = [len(_rows(self.fspec[f])) for f in q["groupby"]]
                rows = [_rows(self.fspec[f]) for f in q["groupby"]]
                counts, sums = (_ints(x) for x in part.cpu())
                ans = {}
                for g, c in enumerate(counts):
                    if c == 0:
                        continue
                    key, rem = [], g
                    for s, rs in zip(reversed(sizes), reversed(rows)):
                        key.append(rs[rem % s])
                        rem //= s
                    ans[tuple(reversed(key))] = (c, sums[g])
                out.append(ans)
            elif "sum" in q:
                s, c = _ints(part.cpu())
                out.append((s, c))
            else:
                out.append(_ints(part.cpu().reshape(1))[0])
        return out


def _ints(t: torch.Tensor) -> List[int]:
    if t.is_floating_point():
        return [int(round(x)) for x in t.double().tolist()]
    return [int(x) for x in t.tolist()]


def answers(cfg: dict, queries: List[dict],
            chunks: Iterable[Dict[str, torch.Tensor]],
            acc: torch.dtype = torch.int64) -> list:
    """Canonical answers of `queries` over every chunk of columns."""
    ref = Reference(cfg, queries, acc)
    for cols in chunks:
        ref.add(cols)
    return ref.answers()
