"""The query codec of the wire encoding: a PQL call tree as JSON.

Own copy of the AST half of featurebase_tpu/cluster/wire.py.  Calls,
conditions, variables and embedded Row/SignedRow payloads round-trip
losslessly (reference: handler.go:17 QueryRequest{Query, PreTranslated,
EmbeddedData}, shipped as protobuf; here a JSON AST with tagged values).
The API logs every PQL write to its WAL in this form
({"op": "pql_ast", "q": encode_query(...)}), so a WAL written by either
package replays in the other.  The result codec of distributed execution
waits for the cluster (ROADMAP.md queue 1 item 14).
"""
from __future__ import annotations

import base64
from typing import Any

import numpy as np

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
