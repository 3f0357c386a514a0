"""The general traffic generator: a mix is a data file,
portbench/traffic/<name>.json, read here.

A mix names its clients and a list of query templates.  A template has a
`weight`, a structured `query` with "$param" placeholders and the `params`
that fill them:

- {"range": [lo, hi]}: a whole number uniform over lo..hi;
- {"choice": [v, ...]}: one of the values;
- {"add": ["param", k]}: an earlier parameter plus k.

Queries are one of
- {"groupby": [field, ...], "aggregate": {"sum": field}, "filter": conds},
- {"sum": field, "filter": conds},
- {"count": conds},
with conds a list of ["==" | "<" | "<=" | ">" | ">=", field, value] or
["between", field, lo, hi], ANDed.  The same structure gives the PQL the
port is sent (to_pql), the bytes its operands occupy
(portbench/metrics/roofline.py) and the reference's answer
(portbench/reference/answers.py).

Each client draws its templates in blocks that hold each template `weight`
times, shuffled from the seed, so every seed sends the same mix in another
order; a query is kept for the check with probability `check_share`.
"""
from __future__ import annotations

import hashlib
import json
import os
import random
from dataclasses import dataclass
from typing import Dict, Iterator, List

PKG = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Query:
    template: str
    spec: str          # the structured query as canonical JSON
    pql: str
    check: bool


def load(name: str) -> dict:
    with open(os.path.join(PKG, "traffic", f"{name}.json")) as f:
        return json.load(f)


def thaw(spec: str) -> dict:
    """The structured query of a Query as a dict."""
    return json.loads(spec)


def _fill(x, params: Dict[str, int]):
    if isinstance(x, str) and x.startswith("$"):
        return params[x[1:]]
    if isinstance(x, list):
        return [_fill(v, params) for v in x]
    if isinstance(x, dict):
        return {k: _fill(v, params) for k, v in x.items()}
    return x


def _domain(p: dict, params: Dict[str, list]) -> list:
    if "range" in p:
        lo, hi = p["range"]
        return list(range(int(lo), int(hi) + 1))
    if "choice" in p:
        return list(p["choice"])
    raise ValueError(f"no domain for {p}")


def _draw(template: dict, rng: random.Random) -> Dict[str, int]:
    params: Dict[str, int] = {}
    for name, p in template.get("params", {}).items():
        if "add" in p:
            base, k = p["add"]
            params[name] = params[base] + int(k)
        elif "range" in p:
            params[name] = rng.randint(int(p["range"][0]), int(p["range"][1]))
        elif "choice" in p:
            params[name] = rng.choice(p["choice"])
        else:
            raise ValueError(f"unknown parameter kind {p}")
    return params


def _cond_pql(c: list, types: Dict[str, str]) -> str:
    op, field = c[0], c[1]
    if op == "between":
        return f"Row({c[2]} <= {field} <= {c[3]})"
    if op == "==" and types[field] == "set":
        return f"Row({field}={c[2]})"
    if op not in ("==", "<", "<=", ">", ">="):
        raise ValueError(f"unknown condition {op!r}")
    return f"Row({field} {op} {c[2]})"


def _filter_pql(conds: list, types: Dict[str, str]) -> str:
    parts = [_cond_pql(c, types) for c in conds]
    return parts[0] if len(parts) == 1 else f"Intersect({', '.join(parts)})"


def to_pql(q: dict, types: Dict[str, str]) -> str:
    """PQL of a structured query; `types` maps field names to set/int."""
    if "groupby" in q:
        args = [f"Rows({f})" for f in q["groupby"]]
        if q.get("filter"):
            args.append(f"filter={_filter_pql(q['filter'], types)}")
        if q.get("aggregate"):
            args.append(f"aggregate=Sum(field={q['aggregate']['sum']})")
        return f"GroupBy({', '.join(args)})"
    if "sum" in q:
        if q.get("filter"):
            return f"Sum({_filter_pql(q['filter'], types)}, " \
                   f"field={q['sum']})"
        return f"Sum(field={q['sum']})"
    if "count" in q:
        return f"Count({_filter_pql(q['count'], types)})"
    raise ValueError(f"unknown query {q}")


def family(q: dict) -> str:
    """The query's family: "groupby", "sum" or "count"."""
    return next(k for k in ("groupby", "sum", "count") if k in q)


def field_types(cfg: dict) -> Dict[str, str]:
    return {f["field"]: f["type"] for f in cfg["fields"]}


def _query(template: dict, params: Dict[str, int], types, check: bool
           ) -> Query:
    q = _fill(template["query"], params)
    return Query(template["name"], json.dumps(q, sort_keys=True),
                 to_pql(q, types), check)


def client_seed(seed: int, client: int) -> int:
    h = hashlib.blake2b(f"traffic:{int(seed)}:{int(client)}".encode(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little")


def stream(mix: dict, cfg: dict, seed: int, client: int) -> Iterator[Query]:
    """Client `client`'s endless query sequence for `seed`."""
    rng = random.Random(client_seed(seed, client))
    types = field_types(cfg)
    share = float(mix.get("check_share", 1.0))
    block = [t for t in mix["templates"] for _ in range(int(t["weight"]))]
    while True:
        order = list(block)
        rng.shuffle(order)
        for t in order:
            params = _draw(t, rng)
            yield _query(t, params, types, rng.random() < share)


def warm_queries(mix: dict, cfg: dict) -> List[Query]:
    """Each template with every value of each of its parameters at least
    once (the i-th query takes the i-th value of each domain, cycling), so
    that every row a mix can read is touched before the window."""
    types = field_types(cfg)
    out = []
    for t in mix["templates"]:
        ps = t.get("params", {})
        doms = {n: _domain(p, {}) for n, p in ps.items() if "add" not in p}
        for i in range(max([len(d) for d in doms.values()] or [1])):
            params: Dict[str, int] = {}
            for n, p in ps.items():
                if "add" in p:
                    params[n] = params[p["add"][0]] + int(p["add"][1])
                else:
                    params[n] = doms[n][i % len(doms[n])]
            out.append(_query(t, params, types, False))
    return out
