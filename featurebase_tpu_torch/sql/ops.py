"""SQL expression evaluation over one record's values (reference:
sql3/planner expression evaluation).  ``eval_expr`` evaluates an expression
against an env dict mapping bare and alias-qualified column names to
values; Apply's per-record route runs it.

Own copy of the expression half of featurebase_tpu/sql/ops.py; the plan
operators come with the SQL planner (ROADMAP.md queue 1 item 10)."""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

from featurebase_tpu_torch.sql.ast import (AGGREGATES, Between, BinOp, Case, Col,
                                     Expr, Func, InList, InSelect, IsNull,
                                     Like, Lit, Star, UnOp)
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
