"""SQL plan operators — a volcano-style operator tree over materialized row
batches (reference: sql3/planner/op*.go 40+ operator files; we keep the same
operator decomposition — PQLTableScan, Filter, NestedLoops, GroupBy,
Projection, OrderBy, Top, Distinct, SystemTable — with batch-at-a-time
execution since the heavy lifting already happened on-device in the PQL
layer).

Each operator's run() returns (schema, rows): schema is a list of
(name, type) pairs; rows are Python lists.  Expression evaluation happens
against an env dict mapping both bare and alias-qualified column names to
values.

Own copy of featurebase_tpu/sql/ops.py.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from featurebase_tpu_torch.sql.ast import (AGGREGATES, Between, BinOp,
                                           Case, Col, Expr, Func, InList,
                                           InSelect, IsNull, Like, Lit, Star,
                                           UnOp)
from featurebase_tpu_torch.sql.functions import call_function


class SQLRuntimeError(Exception):
    pass


# user-defined functions (reference: sql3 CREATE FUNCTION): the planner
# registers the holder's function table for the executing thread; bodies
# parse once per source text
import threading as _threading

_USER_FUNCS = _threading.local()
_UFUNC_AST_CACHE: Dict[str, Expr] = {}


def set_user_functions(funcs: Optional[Dict[str, dict]]):
    _USER_FUNCS.funcs = funcs


def _user_func_ast(src: str) -> Expr:
    ast = _UFUNC_AST_CACHE.get(src)
    if ast is None:
        from featurebase_tpu_torch.sql.parser import Lexer, _expr
        ast = _UFUNC_AST_CACHE[src] = _expr(Lexer(src))
    return ast


# -- expression evaluation -----------------------------------------------------


def like_to_regex(pattern: str):
    return re.compile(
        "^" + re.escape(pattern).replace("%", ".*").replace("_", ".") + "$",
        re.IGNORECASE)


def eval_expr(e: Expr, env: Dict[str, Any]):
    if isinstance(e, Lit):
        return e.value
    if isinstance(e, Col):
        key = f"{e.table}.{e.name}" if e.table else e.name
        if key in env:
            return env[key]
        if e.name in env:
            return env[e.name]
        raise SQLRuntimeError(f"column not found: {key}")
    if isinstance(e, UnOp):
        v = eval_expr(e.operand, env)
        if e.op == "-":
            return -v if v is not None else None
        return not _truthy(v)
    if isinstance(e, BinOp):
        return _eval_binop(e, env)
    if isinstance(e, Func):
        if e.name == "tuple":
            return [eval_expr(a, env) for a in e.args]
        if e.name in AGGREGATES:
            # aggregate refs are resolved to env slots by the group-by op
            key = agg_slot_name(e)
            if key in env:
                return env[key]
            raise SQLRuntimeError(
                f"aggregate {e.name}() outside GROUP BY context")
        ufuncs = getattr(_USER_FUNCS, "funcs", None)
        if ufuncs and e.name.lower() in ufuncs:
            # user-defined SQL function (reference: sql3 CREATE FUNCTION):
            # evaluate the stored body expression with params bound
            fd = ufuncs[e.name.lower()]
            body = _user_func_ast(fd["body"])
            if len(e.args) != len(fd["params"]):
                raise SQLRuntimeError(
                    f"{e.name}() takes {len(fd['params'])} arguments")
            fenv = {p: eval_expr(a, env)
                    for p, a in zip(fd["params"], e.args)}
            return eval_expr(body, fenv)
        return call_function(e.name,
                             [eval_expr(a, env) for a in e.args])
    if isinstance(e, Case):
        if e.operand is not None:
            v = eval_expr(e.operand, env)
            for cond, res in e.whens:
                if eval_expr(cond, env) == v:
                    return eval_expr(res, env)
        else:
            for cond, res in e.whens:
                if _truthy(eval_expr(cond, env)):
                    return eval_expr(res, env)
        return eval_expr(e.else_, env) if e.else_ is not None else None
    if isinstance(e, InList):
        v = eval_expr(e.expr, env)
        if v is None:
            # SQL three-valued logic: NULL IN (...) / NULL NOT IN (...)
            # are both NULL, which filters as false
            return False
        vals = [eval_expr(x, env) for x in e.values]
        hit = any(_contains(v, x) for x in vals if x is not None)
        if e.negated:
            # x NOT IN (..., NULL, ...) is NULL unless x matched
            return (not hit) and not any(x is None for x in vals)
        return hit
    if isinstance(e, InSelect):
        raise SQLRuntimeError("IN (SELECT) must be rewritten by the planner")
    if isinstance(e, Between):
        v = eval_expr(e.expr, env)
        lo, hi = eval_expr(e.lo, env), eval_expr(e.hi, env)
        if v is None:
            return False
        hit = lo <= v <= hi
        return (not hit) if e.negated else hit
    if isinstance(e, IsNull):
        v = eval_expr(e.expr, env)
        isnull = v is None or (isinstance(v, list) and not v)
        return (not isnull) if e.negated else isnull
    if isinstance(e, Like):
        v = eval_expr(e.expr, env)
        if v is None:
            return False
        hit = like_to_regex(e.pattern).match(str(v)) is not None
        return (not hit) if e.negated else hit
    if isinstance(e, Star):
        raise SQLRuntimeError("* not valid here")
    raise SQLRuntimeError(f"cannot evaluate {type(e).__name__}")


def _truthy(v) -> bool:
    return bool(v)


def _contains(lhs, rhs) -> bool:
    """= semantics consistent with the PQL pushdown: on set columns a match
    means set membership (Row(f=v) selects records containing v)."""
    if isinstance(lhs, list):
        return rhs in lhs
    return lhs == rhs


def _eval_binop(e: BinOp, env):
    op = e.op
    if op == "and":
        return _truthy(eval_expr(e.left, env)) and \
            _truthy(eval_expr(e.right, env))
    if op == "or":
        return _truthy(eval_expr(e.left, env)) or \
            _truthy(eval_expr(e.right, env))
    l = eval_expr(e.left, env)
    r = eval_expr(e.right, env)
    if op == "=":
        return _contains(l, r) or _contains(r, l) if isinstance(r, list) \
            else _contains(l, r)
    if op == "!=":
        return not _contains(l, r)
    if l is None or r is None:
        return None if op in ("+", "-", "*", "/", "%", "||") else False
    if op == "<":
        return l < r
    if op == "<=":
        return l <= r
    if op == ">":
        return l > r
    if op == ">=":
        return l >= r
    if op == "+":
        return l + r
    if op == "-":
        return l - r
    if op == "*":
        return l * r
    if op == "/":
        if r == 0:
            return None
        return l // r if isinstance(l, int) and isinstance(r, int) else l / r
    if op == "%":
        return l % r
    if op == "||":
        return str(l) + str(r)
    raise SQLRuntimeError(f"unknown operator {op}")


def agg_slot_name(f: Func) -> str:
    return f"$agg:{repr_expr(f)}"


def repr_expr(e: Expr) -> str:
    """Stable textual form for aliases/agg slot keys."""
    if isinstance(e, Lit):
        return repr(e.value)
    if isinstance(e, Col):
        return f"{e.table}.{e.name}" if e.table else e.name
    if isinstance(e, Star):
        return "*"
    if isinstance(e, UnOp):
        return f"{e.op}{repr_expr(e.operand)}"
    if isinstance(e, BinOp):
        return f"{repr_expr(e.left)}{e.op}{repr_expr(e.right)}"
    if isinstance(e, Func):
        inner = ", ".join(repr_expr(a) for a in e.args)
        d = "distinct " if e.distinct else ""
        return f"{e.name}({d}{inner})"
    if isinstance(e, Case):
        return "case"
    if isinstance(e, InList):
        return f"{repr_expr(e.expr)} in (...)"
    if isinstance(e, Between):
        return f"{repr_expr(e.expr)} between"
    if isinstance(e, IsNull):
        return f"{repr_expr(e.expr)} is null"
    if isinstance(e, Like):
        return f"{repr_expr(e.expr)} like {e.pattern!r}"
    return type(e).__name__


# -- operators ------------------------------------------------------------------

Schema = List[Tuple[str, str]]
Rows = List[list]


class PlanOp:
    def run(self) -> Tuple[Schema, Rows]:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__

    def children(self) -> List["PlanOp"]:
        return []

    def plan_json(self) -> dict:
        """Plan graph for /sql-exec-graph parity (reference:
        http_handler.go:538)."""
        return {"op": self.name(),
                "children": [c.plan_json() for c in self.children()]}


class PlanOpStatic(PlanOp):
    """Literal rows (SELECT without FROM; system responses)."""

    def __init__(self, schema: Schema, rows: Rows):
        self.schema = schema
        self.rows = rows

    def run(self):
        return self.schema, self.rows


class PlanOpFilter(PlanOp):
    def __init__(self, child: PlanOp, pred: Expr):
        self.child = child
        self.pred = pred

    def children(self):
        return [self.child]

    def run(self):
        schema, rows = self.child.run()
        out = []
        for row in rows:
            env = make_env(schema, row)
            if _truthy(eval_expr(self.pred, env)):
                out.append(row)
        return schema, out


class PlanOpNestedLoops(PlanOp):
    """Inner / left join (reference: sql3/planner/opnestedloops.go).  Uses a
    hash table on equality keys when the ON clause is a conjunction of
    equality comparisons; degrades to full nested loops otherwise."""

    def __init__(self, left: PlanOp, right: PlanOp, kind: str,
                 on: Optional[Expr]):
        self.left = left
        self.right = right
        self.kind = kind
        self.on = on

    def children(self):
        return [self.left, self.right]

    def run(self):
        ls, lrows = self.left.run()
        rs, rrows = self.right.run()
        schema = ls + rs
        out: Rows = []
        null_right = [None] * len(rs)
        for lrow in lrows:
            matched = False
            for rrow in rrows:
                row = lrow + rrow
                if self.on is None or _truthy(
                        eval_expr(self.on, make_env(schema, row))):
                    out.append(row)
                    matched = True
            if not matched and self.kind == "left":
                out.append(lrow + null_right)
        return schema, out


class PlanOpDistinct(PlanOp):
    def __init__(self, child: PlanOp):
        self.child = child

    def children(self):
        return [self.child]

    def run(self):
        schema, rows = self.child.run()
        seen = set()
        out = []
        for r in rows:
            k = tuple(tuple(v) if isinstance(v, list) else v for v in r)
            if k not in seen:
                seen.add(k)
                out.append(r)
        return schema, out


class PlanOpOrderBy(PlanOp):
    def __init__(self, child: PlanOp, keys: List[Tuple[Callable, bool]]):
        """keys: list of (key_fn(schema,row) -> value, desc)."""
        self.child = child
        self.keys = keys

    def children(self):
        return [self.child]

    def run(self):
        schema, rows = self.child.run()
        for key_fn, desc in reversed(self.keys):
            rows.sort(key=lambda r: _sort_key(key_fn(schema, r)),
                      reverse=desc)
        return schema, rows


def _sort_key(v):
    # None sorts first ascending (reference: SQL NULLS FIRST asc)
    if v is None:
        return (0, 0)
    if isinstance(v, bool):
        return (1, int(v))
    if isinstance(v, (int, float)):
        return (1, v)
    if isinstance(v, list):
        return (3, tuple(str(x) for x in v))
    return (2, str(v))


class PlanOpTop(PlanOp):
    def __init__(self, child: PlanOp, limit: Optional[int], offset: int = 0):
        self.child = child
        self.limit = limit
        self.offset = offset

    def children(self):
        return [self.child]

    def run(self):
        schema, rows = self.child.run()
        if self.offset:
            rows = rows[self.offset:]
        if self.limit is not None:
            rows = rows[: self.limit]
        return schema, rows


class PlanOpProjection(PlanOp):
    def __init__(self, child: PlanOp, items: List[Tuple[str, str, Expr]]):
        """items: (out_name, out_type, expr)."""
        self.child = child
        self.items = items

    def children(self):
        return [self.child]

    def run(self):
        schema, rows = self.child.run()
        out_schema = [(n, t) for n, t, _ in self.items]
        out = []
        for row in rows:
            env = make_env(schema, row)
            out.append([eval_expr(e, env) for _, _, e in self.items])
        return out_schema, out


def make_env(schema: Schema, row: list) -> Dict[str, Any]:
    env: Dict[str, Any] = {}
    for (name, _), v in zip(schema, row):
        env[name] = v
    # bare-name fallback for qualified columns: first (leftmost) wins, the
    # lax mode common engines use for unambiguous-enough references
    for (name, _), v in zip(schema, row):
        if "." in name:
            env.setdefault(name.split(".", 1)[1], v)
    return env


class PlanOpGroupBy(PlanOp):
    """Hash aggregation (general path; the PQL-pushdown fast path is a
    separate operator built by the planner — reference: planoptimizer.go:661
    GroupBy->PQLGroupBy when eligible)."""

    def __init__(self, child: PlanOp, group_exprs: List[Expr],
                 aggs: List[Func]):
        self.child = child
        self.group_exprs = group_exprs
        self.aggs = aggs

    def children(self):
        return [self.child]

    def run(self):
        schema, rows = self.child.run()
        groups: Dict[tuple, dict] = {}
        order: List[tuple] = []
        for row in rows:
            env = make_env(schema, row)
            key = tuple(_hashable(eval_expr(g, env))
                        for g in self.group_exprs)
            st = groups.get(key)
            if st is None:
                st = {"env": env,
                      "acc": [AggAcc(a) for a in self.aggs]}
                groups[key] = st
                order.append(key)
            for acc in st["acc"]:
                acc.add(env)
        out_schema = [(repr_expr(g), "") for g in self.group_exprs] + \
            [(agg_slot_name(a), "") for a in self.aggs]
        out_rows = []
        for key in sorted(order, key=lambda k: tuple(_sort_key(x)
                                                     for x in k)):
            st = groups[key]
            out_rows.append(list(key) + [acc.result() for acc in st["acc"]])
        return out_schema, out_rows


def _hashable(v):
    return tuple(v) if isinstance(v, list) else v


class AggAcc:
    """One aggregate accumulator (reference: sql3/planner/expressionagg.go)."""

    def __init__(self, f: Func):
        self.f = f
        self.kind = f.name
        self.distinct = f.distinct
        self.seen = set() if f.distinct else None
        self.count = 0
        self.sum = 0
        self.min = None
        self.max = None
        self.values: List[Any] = []
        # corr accumulators (reference: aggregateCorr sums,
        # expressionagg.go:1027-1035)
        self.sum_y = 0.0
        self.sum_xy = 0.0
        self.sq_x = 0.0
        self.sq_y = 0.0

    def add(self, env):
        if self.kind == "corr":
            if len(self.f.args) != 2:
                raise SQLRuntimeError("corr() takes two arguments")
            x = eval_expr(self.f.args[0], env)
            y = eval_expr(self.f.args[1], env)
            if x is None or y is None:
                return
            x, y = float(x), float(y)
            self.count += 1
            self.sum += x
            self.sum_y += y
            self.sum_xy += x * y
            self.sq_x += x * x
            self.sq_y += y * y
            return
        arg = self.f.args[0] if self.f.args else Star()
        if isinstance(arg, Star):
            v = 1
        else:
            v = eval_expr(arg, env)
        if v is None or (isinstance(v, list) and not v):
            return
        if self.distinct:
            k = _hashable(v)
            if k in self.seen:
                return
            self.seen.add(k)
        self.count += 1
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if self.kind in ("percentile", "var", "corr"):
                self.values.append(v)
        elif self.kind in ("min", "max"):
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def result(self):
        if self.kind == "count":
            return self.count
        if self.kind == "sum":
            return self.sum if self.count else None
        if self.kind == "avg":
            return self.sum / self.count if self.count else None
        if self.kind == "min":
            return self.min
        if self.kind == "max":
            return self.max
        if self.kind == "percentile":
            if not self.values:
                return None
            nth = float(eval_expr(self.f.args[1], {})) \
                if len(self.f.args) > 1 else 50.0
            return _pql_percentile(self.values, nth)
        if self.kind == "var":
            # population variance, 6dp (reference expressionagg.go:1183:
            # variance/n, decimal scale 6)
            if self.count == 0:
                return None
            mean = self.sum / self.count
            return round(sum((x - mean) ** 2
                             for x in self.values) / self.count, 6)
        if self.kind == "corr":
            n = self.count
            if n == 0:
                return None
            num = n * self.sum_xy - self.sum * self.sum_y
            den2 = (n * self.sq_x - self.sum * self.sum) * \
                (n * self.sq_y - self.sum_y * self.sum_y)
            if den2 <= 0:
                return None  # zero variance: the reference yields NaN
            import math
            return round(num / math.sqrt(den2), 6)
        raise SQLRuntimeError(f"unknown aggregate {self.kind}")


def _pql_percentile(values, nth: float):
    """Reference Percentile bisection over a value list (executor.go:1310)
    — the same math as the engine's fused device program, so volcano
    residual paths agree with PQL pushdown.  Integer values bisect
    exactly (Go-truncating pivot arithmetic, executor.go:1497-1500);
    float (decimal) values bisect in 1e-2-scaled integer space, matching
    the engine's stored-unit arithmetic for DECIMAL(2)."""
    scale = 1
    if any(isinstance(v, float) and not float(v).is_integer()
           for v in values):
        scale = 100
    vs = [round(v * scale) for v in values]
    total = len(vs)
    num0, den0 = float(nth).as_integer_ratio()
    d100 = den0 * 100
    desired_less = total * num0 // d100
    desired_greater = total * (d100 - num0) // d100
    mn, mx = min(vs), max(vs)
    if desired_greater != 0 and desired_less == 0:
        return mn / scale if scale > 1 else mn
    if desired_greater == 0:
        return mx / scale if scale > 1 else mx

    def tdiv(a, b):
        return -(-a // b) if (a < 0) != (b < 0) else a // b

    lo, hi = mn, mx
    possible = lo
    while lo < hi:
        possible = (tdiv(lo, 2) + tdiv(hi, 2)
                    + tdiv(tdiv(lo, 2) * -2 + lo + tdiv(hi, 2) * -2 + hi, 2))
        left = sum(1 for v in vs if v < possible)
        if left > desired_less:
            hi = possible - 1
            continue
        right = sum(1 for v in vs if v > possible)
        if right > desired_greater:
            lo = possible + 1
            continue
        break
    return possible / scale if scale > 1 else possible
