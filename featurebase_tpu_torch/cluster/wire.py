"""The wire encoding of distributed execution: PQL call trees and partial
results as JSON.

Own copy of featurebase_tpu/cluster/wire.py, in its formats, so a node of
either package reads the other's messages.  Calls, conditions, variables
and embedded Row/SignedRow payloads round-trip losslessly (reference:
handler.go:17 QueryRequest{Query, PreTranslated, EmbeddedData}, shipped as
protobuf; here a JSON AST with tagged values).  The API logs every PQL
write to its WAL in this form ({"op": "pql_ast", "q": encode_query(...)}).

Partial results carry a type tag, so the coordinator decodes each node's
partial for the merge (reference: executor.go:6487-6533 reduce).  A Row
travels as its sorted int64 column ids, base64-encoded: the words decode
to columns on the host of the node that sends it (model/row.py::columns)
and encode back to words on the coordinator.
"""
from __future__ import annotations

import base64
from typing import Any

import numpy as np

from featurebase_tpu_torch.executor.results import (ExtractedIDColumn,
                                                    ExtractedIDMatrix,
                                                    ExtractedTable,
                                                    ExtractedTableColumn,
                                                    ExtractedTableField,
                                                    FieldRow, GroupCount,
                                                    Pair, PairField,
                                                    PairsField, ValCount)
from featurebase_tpu_torch.model.row import Row, SignedRow
from featurebase_tpu_torch.pql.ast import Call, Condition, Query, Variable


def encode_value(v: Any):
    if isinstance(v, Call):
        return {"$call": encode_call(v)}
    if isinstance(v, Condition):
        return {"$cond": {"op": v.op, "value": encode_value(v.value),
                          "loStrict": v.lo_strict, "hiStrict": v.hi_strict}}
    if isinstance(v, Variable):
        return {"$var": v.name}
    if isinstance(v, Row):
        return {"$row": encode_row(v)}
    if isinstance(v, SignedRow):
        return {"$signedrow": {"neg": encode_row(v.neg),
                               "pos": encode_row(v.pos), "field": v.field}}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [encode_value(x) for x in v]
    return v


def decode_value(v: Any):
    if isinstance(v, dict):
        if "$call" in v:
            return decode_call(v["$call"])
        if "$cond" in v:
            c = v["$cond"]
            return Condition(c["op"], decode_value(c["value"]),
                             c.get("loStrict", False), c.get("hiStrict", False))
        if "$var" in v:
            return Variable(v["$var"])
        if "$row" in v:
            return decode_row(v["$row"])
        if "$signedrow" in v:
            s = v["$signedrow"]
            return SignedRow(decode_row(s["neg"]), decode_row(s["pos"]),
                             field=s.get("field"))
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


def encode_call(call: Call) -> dict:
    return {"name": call.name,
            "args": {k: encode_value(v) for k, v in call.args.items()},
            "children": [encode_call(c) for c in call.children]}


def decode_call(d: dict) -> Call:
    return Call(d["name"],
                {k: decode_value(v) for k, v in (d.get("args") or {}).items()},
                [decode_call(c) for c in d.get("children") or []])


def encode_query(q: Query) -> list:
    return [encode_call(c) for c in q.calls]


def decode_query(calls: list) -> Query:
    return Query([decode_call(c) for c in calls])


def encode_row(row: Row) -> dict:
    cols = row.columns()
    b = np.asarray(cols, dtype=np.int64).tobytes()
    return {"cols": base64.b64encode(b).decode("ascii")}


def decode_row(d: dict) -> Row:
    b = base64.b64decode(d.get("cols", ""))
    cols = np.frombuffer(b, dtype=np.int64)
    return Row.from_columns(cols)


def encode_result(r: Any):
    """A partial result as a tagged JSON value (node -> coordinator)."""
    if isinstance(r, bool):
        return {"t": "bool", "v": r}
    if isinstance(r, (int, np.integer)):
        return {"t": "int", "v": int(r)}
    if isinstance(r, Row):
        return {"t": "row", "v": encode_row(r)}
    if isinstance(r, SignedRow):
        return {"t": "signedrow", "v": {"neg": encode_row(r.neg),
                                        "pos": encode_row(r.pos),
                                        "field": r.field}}
    if isinstance(r, ValCount):
        return {"t": "valcount",
                "v": {"val": r.val, "count": r.count,
                      "floatVal": r.float_val, "decimalVal": r.decimal_val,
                      "timestampVal": r.timestamp_val}}
    if isinstance(r, PairsField):
        return {"t": "pairsfield",
                "v": {"field": r.field,
                      "pairs": [[p.id, p.count, p.key] for p in r.pairs]}}
    if isinstance(r, PairField):
        return {"t": "pairfield",
                "v": {"field": r.field,
                      "pair": [r.pair.id, r.pair.count, r.pair.key]}}
    if isinstance(r, list) and r and isinstance(r[0], GroupCount):
        return {"t": "groupcounts", "v": [_encode_groupcount(g) for g in r]}
    if isinstance(r, list):
        return {"t": "list", "v": [int(x) if isinstance(x, np.integer) else x
                                   for x in r]}
    if isinstance(r, ExtractedIDMatrix):
        return {"t": "idmatrix",
                "v": {"fields": r.fields,
                      "columns": [[c.column, c.rows] for c in r.columns]}}
    if isinstance(r, ExtractedTable):
        return {"t": "table",
                "v": {"fields": [[f.name, f.type] for f in r.fields],
                      "columns": [[c.column, c.rows] for c in r.columns]}}
    if isinstance(r, dict):
        return {"t": "dict", "v": r}
    if r is None:
        return {"t": "null", "v": None}
    raise TypeError(f"cannot encode result type {type(r)}")


def decode_result(d: dict) -> Any:
    t, v = d["t"], d["v"]
    if t in ("bool", "int", "list", "dict", "null"):
        return v
    if t == "row":
        return decode_row(v)
    if t == "signedrow":
        return SignedRow(decode_row(v["neg"]), decode_row(v["pos"]),
                         field=v.get("field"))
    if t == "valcount":
        return ValCount(v["val"], v["count"], v.get("floatVal"),
                        v.get("decimalVal"), v.get("timestampVal"))
    if t == "pairsfield":
        return PairsField([Pair(p[0], p[1], p[2]) for p in v["pairs"]],
                          v["field"])
    if t == "pairfield":
        p = v["pair"]
        return PairField(Pair(p[0], p[1], p[2]), v["field"])
    if t == "groupcounts":
        return [_decode_groupcount(g) for g in v]
    if t == "idmatrix":
        return ExtractedIDMatrix(
            v["fields"],
            [ExtractedIDColumn(c[0], c[1]) for c in v["columns"]])
    if t == "table":
        return ExtractedTable(
            [ExtractedTableField(f[0], f[1]) for f in v["fields"]],
            [ExtractedTableColumn(c[0], c[1]) for c in v["columns"]])
    raise TypeError(f"cannot decode result tag {t}")


def _encode_groupcount(g: GroupCount) -> dict:
    return {"group": [{"field": fr.field, "rowID": fr.row_id,
                       "rowKey": fr.row_key, "value": fr.value}
                      for fr in g.group],
            "count": g.count, "agg": g.agg, "decimalAgg": g.decimal_agg}


def _decode_groupcount(d: dict) -> GroupCount:
    group = [FieldRow(fr["field"], fr.get("rowID", 0), fr.get("rowKey"),
                      fr.get("value")) for fr in d["group"]]
    return GroupCount(group, d.get("count", 0), d.get("agg", 0),
                      d.get("decimalAgg"))
