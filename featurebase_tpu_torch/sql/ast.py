"""SQL AST nodes: the expressions (reference: sql3/parser/ast.go).  A small
orthogonal core: literals, column refs, unary/binary operators, function
calls, CASE, IN/BETWEEN/LIKE/IS NULL predicates, and scalar subqueries.

Own copy of the expression half of featurebase_tpu/sql/ast.py, which
Apply's programs evaluate; the statement nodes come with the SQL planner
(ROADMAP.md queue 1 item 10)."""
from __future__ import annotations

from typing import List, Optional, Tuple


# -- expressions --------------------------------------------------------------

class Expr:
    __slots__ = ()


class Lit(Expr):
    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __repr__(self):
        return f"Lit({self.value!r})"


class Col(Expr):
    __slots__ = ("table", "name")

    def __init__(self, name: str, table: Optional[str] = None):
        self.name = name
        self.table = table

    def __repr__(self):
        return f"Col({self.table + '.' if self.table else ''}{self.name})"


class Star(Expr):
    __slots__ = ("table",)

    def __init__(self, table: Optional[str] = None):
        self.table = table


class BinOp(Expr):
    """op in + - * / % = != < <= > >= AND OR || (concat)"""
    __slots__ = ("op", "left", "right")

    def __init__(self, op: str, left: Expr, right: Expr):
        self.op, self.left, self.right = op, left, right

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


class UnOp(Expr):
    """op in - NOT"""
    __slots__ = ("op", "operand")

    def __init__(self, op: str, operand: Expr):
        self.op, self.operand = op, operand


class Func(Expr):
    """Scalar or aggregate function call; distinct applies to aggregates."""
    __slots__ = ("name", "args", "distinct")

    def __init__(self, name: str, args: List[Expr], distinct: bool = False):
        self.name = name.lower()
        self.args = args
        self.distinct = distinct

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


class Case(Expr):
    __slots__ = ("operand", "whens", "else_")

    def __init__(self, operand: Optional[Expr],
                 whens: List[Tuple[Expr, Expr]], else_: Optional[Expr]):
        self.operand = operand
        self.whens = whens
        self.else_ = else_


class InList(Expr):
    __slots__ = ("expr", "values", "negated")

    def __init__(self, expr: Expr, values: List[Expr], negated: bool = False):
        self.expr, self.values, self.negated = expr, values, negated


class InSelect(Expr):
    __slots__ = ("expr", "select", "negated")

    def __init__(self, expr: Expr, select, negated: bool = False):
        self.expr, self.select, self.negated = expr, select, negated


class ScalarSubquery(Expr):
    """(SELECT ...) used as a scalar value (reference: sql3/parser
    exprs.go subquery expressions); the planner evaluates it eagerly and
    substitutes the single-cell result."""
    __slots__ = ("select",)

    def __init__(self, select):
        self.select = select


class Between(Expr):
    __slots__ = ("expr", "lo", "hi", "negated")

    def __init__(self, expr: Expr, lo: Expr, hi: Expr, negated: bool = False):
        self.expr, self.lo, self.hi, self.negated = expr, lo, hi, negated


class IsNull(Expr):
    __slots__ = ("expr", "negated")

    def __init__(self, expr: Expr, negated: bool = False):
        self.expr, self.negated = expr, negated


class Like(Expr):
    __slots__ = ("expr", "pattern", "negated")

    def __init__(self, expr: Expr, pattern: str, negated: bool = False):
        self.expr, self.pattern, self.negated = expr, pattern, negated


AGGREGATES = {"count", "sum", "min", "max", "avg", "percentile", "corr", "var"}
