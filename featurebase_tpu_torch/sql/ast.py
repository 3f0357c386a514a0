"""SQL AST nodes (reference: sql3/parser/ast.go, 4912 LoC — statements,
expressions, data types).  Expressions are a small orthogonal core: literals,
column refs, unary/binary operators, function calls, CASE, IN/BETWEEN/LIKE/
IS NULL predicates, and scalar subqueries.

Own copy of featurebase_tpu/sql/ast.py."""
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


# -- statements ---------------------------------------------------------------

class SelectItem:
    __slots__ = ("expr", "alias")

    def __init__(self, expr: Expr, alias: Optional[str] = None):
        self.expr = expr
        self.alias = alias


class TableRef:
    """FROM item: a named table/view, a subquery, or a table-valued
    function call (fn_args is not None), each with an alias.  Reference:
    the sql3 planner plans TVFs (optablevaluedfunction.go) but its
    iterator is unimplemented; here they execute."""
    __slots__ = ("name", "subquery", "alias", "fn_args")

    def __init__(self, name: Optional[str] = None, subquery=None,
                 alias: Optional[str] = None, fn_args=None):
        self.name = name
        self.subquery = subquery
        self.alias = alias or name
        self.fn_args = fn_args

    def __repr__(self):
        return f"TableRef({self.name or '<subquery>'} as {self.alias})"


class Join:
    """kind in inner|left"""
    __slots__ = ("kind", "table", "on")

    def __init__(self, kind: str, table: TableRef, on: Optional[Expr]):
        self.kind, self.table, self.on = kind, table, on


class Select:
    __slots__ = ("items", "table", "joins", "where", "group_by", "having",
                 "order_by", "limit", "offset", "distinct")

    def __init__(self):
        self.items: List[SelectItem] = []
        self.table: Optional[TableRef] = None
        self.joins: List[Join] = []
        self.where: Optional[Expr] = None
        self.group_by: List[Expr] = []
        self.having: Optional[Expr] = None
        self.order_by: List[Tuple[Expr, bool]] = []  # (expr, desc)
        self.limit: Optional[int] = None
        self.offset: int = 0
        self.distinct = False


class CreateTable:
    __slots__ = ("name", "columns", "if_not_exists", "options")

    def __init__(self, name, columns, if_not_exists=False, options=None):
        self.name = name
        self.columns = columns  # list of (name, type, opts dict)
        self.if_not_exists = if_not_exists
        self.options = options or {}


class AlterTable:
    """action in add|drop|rename; column = (name, type, opts) for add."""
    __slots__ = ("table", "action", "column", "new_name")

    def __init__(self, table, action, column=None, new_name=None):
        self.table, self.action = table, action
        self.column, self.new_name = column, new_name


class DropTable:
    __slots__ = ("name", "if_exists")

    def __init__(self, name, if_exists=False):
        self.name = name
        self.if_exists = if_exists


class CreateView:
    __slots__ = ("name", "select_sql", "if_not_exists")

    def __init__(self, name, select_sql, if_not_exists=False):
        self.name = name
        self.select_sql = select_sql
        self.if_not_exists = if_not_exists


class DropView:
    __slots__ = ("name", "if_exists")

    def __init__(self, name, if_exists=False):
        self.name = name
        self.if_exists = if_exists


class AlterView:
    __slots__ = ("name", "select_sql")

    def __init__(self, name, select_sql):
        self.name = name
        self.select_sql = select_sql


class Insert:
    __slots__ = ("table", "columns", "rows", "replace")

    def __init__(self, table, columns, rows, replace=False):
        self.table = table
        self.columns = columns
        self.rows = rows
        self.replace = replace


class BulkInsert:
    """BULK INSERT INTO t (cols) [MAP (pos TYPE, ...)]
    [TRANSFORM (@n|literal, ...)] FROM 'file'|x'inline'
    WITH [BATCHSIZE n] [FORMAT 'CSV'] [INPUT 'FILE'|'STREAM']
    (reference: sql3 BULK INSERT, defs_bulkinsert.go)."""
    __slots__ = ("table", "columns", "source", "format", "header",
                 "map_spec", "transform", "inline")

    def __init__(self, table, columns, source, format="CSV", header=True,
                 map_spec=None, transform=None, inline=False):
        self.table = table
        self.columns = columns
        self.source = source
        self.format = format
        self.header = header
        self.map_spec = map_spec    # [(source_pos, type_str)] or None
        self.transform = transform  # [int @pos | ("lit", v)] or None
        self.inline = inline        # True: source is the data itself


class Delete:
    __slots__ = ("table", "where")

    def __init__(self, table, where):
        self.table = table
        self.where = where


class Show:
    """what in tables|columns|databases|views|create_table"""
    __slots__ = ("what", "table")

    def __init__(self, what, table=None):
        self.what = what
        self.table = table


class CreateDatabase:
    """CREATE DATABASE name [WITH option value ...] (reference: sql3
    CREATE DATABASE, sql3/parser dialect)."""
    __slots__ = ("name", "options", "if_not_exists")

    def __init__(self, name, options=None, if_not_exists=False):
        self.name = name
        self.options = options or {}
        self.if_not_exists = if_not_exists


class DropDatabase:
    __slots__ = ("name", "if_exists")

    def __init__(self, name, if_exists=False):
        self.name = name
        self.if_exists = if_exists


class CreateFunction:
    """CREATE FUNCTION name(@p type, ...) RETURNS type AS (expr)
    (reference: sql3 CREATE FUNCTION)."""
    __slots__ = ("name", "params", "returns", "body_src", "if_not_exists")

    def __init__(self, name, params, returns, body_src,
                 if_not_exists=False):
        self.name = name
        self.params = params      # [(name, type), ...]
        self.returns = returns
        self.body_src = body_src
        self.if_not_exists = if_not_exists


class DropFunction:
    __slots__ = ("name", "if_exists")

    def __init__(self, name, if_exists=False):
        self.name = name
        self.if_exists = if_exists


class Copy:
    """COPY table TO 'file.csv' | COPY table FROM 'file.csv'
    (reference: sql3 COPY)."""
    __slots__ = ("table", "direction", "path")

    def __init__(self, table, direction, path):
        self.table = table
        self.direction = direction  # "to" | "from"
        self.path = path
