"""Bytes a query's operands occupy on the card, and the bound they set.

Each row of every shard that a query's operands name is counted once,
whatever kernel reads it and however often: a GroupBy dimension every row
of its field; an equality on a set field its row; a range on an int field,
or its Sum, the field's BSI group (exists, sign and the magnitude planes).
A row counts in the shards that hold it (set-up's `stored`), or, without
that, in every shard.
The bound is those bytes over the card's HBM bandwidth (NVIDIA H100 SXM5
80 GB data sheet: 3.35 TB/s, at the full 700 W power limit).
"""
from __future__ import annotations

from portbench import datagen

HBM_BYTES_PER_S = 3.35e12
ROW_BYTES = datagen.RECORDS_PER_SHARD // 8


def operands(q: dict, cfg: dict) -> dict:
    """{(field, row id or "bsi"): rows a shard} that the query names."""
    fspec = {f["field"]: f for f in cfg["fields"]}
    rows = {}

    def group(f):
        rows[(f, "bsi")] = datagen.bsi_depth(fspec[f]) + 2

    def cond(c):
        f = c[1]
        if fspec[f]["type"] == "set" and c[0] == "==":
            rows[(f, int(c[2]))] = 1
        else:
            group(f)
    for f in q.get("groupby", ()):
        for r in datagen.field_rows(fspec[f]):
            rows[(f, r)] = 1
    if q.get("aggregate"):
        group(q["aggregate"]["sum"])
    if "sum" in q:
        group(q["sum"])
    for c in q.get("filter") or q.get("count") or ():
        cond(c)
    return rows


def rows_read(q: dict, cfg: dict) -> int:
    """Rows a shard the query names, every row in every shard."""
    return sum(operands(q, cfg).values())


def bytes_of(q: dict, cfg: dict, stored=None) -> int:
    shards = int(cfg["shards"])
    return ROW_BYTES * sum(
        n * (shards if stored is None else stored.get(k, 0))
        for k, n in operands(q, cfg).items())


def share(ctx, family: str):
    """Percent of the HBM bound of the window's queries of `family`
    ("groupby", "sum", "count") over the device time linked to them; None
    without such a query or a trace."""
    from portbench.traffic import thaw
    if ctx.trace is None:
        return None
    took = ctx.trace.device_s_by_family.get(family, 0.0)
    need = sum(bytes_of(q, ctx.cfg, ctx.stored) for r in ctx.window.records
               if family in (q := thaw(r.query.spec))) / HBM_BYTES_PER_S
    return 100.0 * need / took if took > 0 and need > 0 else None
