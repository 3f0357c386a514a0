"""SQL parser — hand-written lexer + recursive-descent parser for the
reference dialect subset that lowers onto the PQL layer (reference:
sql3/parser/parser.go hand-written parser, token.go, astdatatype.go).

Statements: SELECT (expressions, aliases, DISTINCT, TOP, joins, subqueries
in FROM and IN, GROUP BY/HAVING, ORDER BY, LIMIT/OFFSET), CREATE/ALTER/DROP
TABLE, CREATE/DROP VIEW, INSERT/REPLACE, BULK INSERT, DELETE, SHOW
TABLES|DATABASES|VIEWS|COLUMNS|CREATE TABLE.

Expression grammar (precedence low->high):
  OR < AND < NOT < predicate (cmp, IN, BETWEEN, LIKE, IS NULL)
     < additive (+ - ||) < multiplicative (* / %) < unary (-) < primary

Own copy of featurebase_tpu/sql/parser.py.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

from featurebase_tpu_torch.sql.ast import (AlterTable, AlterView, Between,
                                           BinOp, BulkInsert, Case, Col, Copy,
                                           CreateDatabase, CreateFunction,
                                           CreateTable, CreateView, Delete,
                                           DropDatabase, DropFunction,
                                           DropTable, DropView, Expr, Func,
                                           InList, InSelect, Insert, IsNull,
                                           Join, Like, Lit, ScalarSubquery,
                                           Select, SelectItem, Show, Star,
                                           TableRef, UnOp)

_TOKEN_RX = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<qident>"(?:[^"]|"")*")
    | (?P<op><=|>=|<>|!=|\|\||=|<|>|\(|\)|,|\*|/|%|\+|-|;|\.|\[|\]|@)
    | (?P<word>[A-Za-z_][A-Za-z0-9_\-]*)
    )""", re.VERBOSE)


class SQLError(Exception):
    pass


class Lexer:
    def __init__(self, src: str):
        self.src = src
        self.tokens: List[Tuple[str, Any, int]] = []
        i = 0
        while i < len(src):
            m = _TOKEN_RX.match(src, i)
            if not m or m.end() == i:
                if src[i:].strip() == "":
                    break
                raise SQLError(f"bad token at {i}: {src[i:i+16]!r}")
            start, i = m.start(), m.end()
            if m.group("num") is not None:
                t = m.group("num")
                self.tokens.append(
                    ("num", float(t) if "." in t else int(t), start))
            elif m.group("str") is not None:
                s = m.group("str")
                self.tokens.append(("str", s[1:-1].replace("''", "'"), start))
            elif m.group("qident") is not None:
                s = m.group("qident")
                self.tokens.append(
                    ("word", s[1:-1].replace('""', '"'), start))
            elif m.group("op") is not None:
                self.tokens.append(("op", m.group("op"), start))
            else:
                self.tokens.append(("word", m.group("word"), start))
        self.pos = 0

    def peek(self, ahead: int = 0) -> Tuple[str, Any]:
        p = self.pos + ahead
        if p < len(self.tokens):
            return self.tokens[p][:2]
        return ("eof", None)

    def next(self) -> Tuple[str, Any]:
        t = self.peek()
        self.pos += 1
        return t

    def at_kw(self, word: str, ahead: int = 0) -> bool:
        k, v = self.peek(ahead)
        return k == "word" and v.lower() == word

    def try_kw(self, *words: str) -> bool:
        save = self.pos
        for w in words:
            k, v = self.next()
            if k != "word" or v.lower() != w:
                self.pos = save
                return False
        return True

    def expect_kw(self, *words: str):
        if not self.try_kw(*words):
            raise SQLError(f"expected {' '.join(words).upper()} near "
                           f"{self.peek()[1]!r}")

    def try_op(self, op: str) -> bool:
        k, v = self.peek()
        if k == "op" and v == op:
            self.pos += 1
            return True
        return False

    def expect_op(self, op: str):
        if not self.try_op(op):
            raise SQLError(f"expected {op!r} near {self.peek()[1]!r}")

    def ident(self) -> str:
        k, v = self.next()
        if k != "word":
            raise SQLError(f"expected identifier, got {v!r}")
        return v

    def span_from(self, mark: int) -> str:
        """Raw SQL text from token index `mark` to current position."""
        if mark >= len(self.tokens):
            return ""
        start = self.tokens[mark][2]
        end = (self.tokens[self.pos][2] if self.pos < len(self.tokens)
               else len(self.src))
        return self.src[start:end].strip()


# -- entry --------------------------------------------------------------------

def parse_sql(src: str):
    lx = Lexer(src)
    stmts = []
    while lx.peek()[0] != "eof":
        stmts.append(_statement(lx))
        while lx.try_op(";"):
            pass
    if not stmts:
        raise SQLError("empty statement")
    return stmts


_RESERVED_AFTER_SELECT = {"from", "where", "group", "having", "order",
                          "limit", "offset", "as", "asc", "desc", "join",
                          "inner", "left", "on", "and", "or", "not",
                          "between", "in", "is", "like", "union", "top",
                          "distinct", "case", "when", "then", "else", "end"}


def _statement(lx: Lexer):
    k, v = lx.peek()
    if k != "word":
        raise SQLError(f"expected statement, got {v!r}")
    w = v.lower()
    if w == "select":
        return _select(lx)
    if w == "create":
        return _create(lx)
    if w == "alter":
        return _alter(lx)
    if w == "drop":
        lx.next()
        if lx.try_kw("view"):
            ife = lx.try_kw("if", "exists")
            return DropView(lx.ident(), ife)
        if lx.try_kw("database"):
            ife = lx.try_kw("if", "exists")
            return DropDatabase(lx.ident(), ife)
        if lx.try_kw("function"):
            ife = lx.try_kw("if", "exists")
            return DropFunction(lx.ident(), ife)
        lx.expect_kw("table")
        ife = lx.try_kw("if", "exists")
        return DropTable(lx.ident(), ife)
    if w == "copy":
        lx.next()
        table = lx.ident()
        if lx.try_kw("to"):
            direction = "to"
        else:
            lx.expect_kw("from")
            direction = "from"
        k, v = lx.next()
        if k == "word" and direction == "to":
            # COPY src TO dst — table-to-table clone (reference:
            # defs_copy.go; the quoted-path file form is an extension)
            return Copy(table, "clone", v)
        if k != "str":
            raise SQLError("COPY requires a table name or quoted path")
        return Copy(table, direction, v)
    if w == "bulk":
        return _bulk_insert(lx)
    if w in ("insert", "replace"):
        return _insert(lx, replace=(w == "replace"))
    if w == "delete":
        lx.next()
        lx.expect_kw("from")
        table = lx.ident()
        where = _expr(lx) if lx.try_kw("where") else None
        return Delete(table, where)
    if w == "show":
        lx.next()
        if lx.try_kw("tables"):
            return Show("tables")
        if lx.try_kw("databases"):
            return Show("databases")
        if lx.try_kw("views"):
            return Show("views")
        if lx.try_kw("functions"):
            return Show("functions")
        if lx.try_kw("create", "table"):
            return Show("create_table", lx.ident())
        if lx.try_kw("columns") or lx.try_kw("fields"):
            lx.expect_kw("from")
            return Show("columns", lx.ident())
        raise SQLError("expected TABLES/DATABASES/VIEWS/COLUMNS/CREATE TABLE "
                       "after SHOW")
    raise SQLError(f"unsupported statement: {v}")


# -- SELECT ---------------------------------------------------------------------

def _select(lx: Lexer) -> Select:
    lx.expect_kw("select")
    sel = Select()
    if lx.try_kw("distinct"):
        sel.distinct = True
    if lx.try_kw("top"):
        if lx.try_op("("):
            k, n = lx.next()
            lx.expect_op(")")
        else:
            k, n = lx.next()
        sel.limit = int(n)
    while True:
        if lx.try_op("*"):
            sel.items.append(SelectItem(Star()))
        else:
            e = _expr(lx)
            alias = None
            if lx.try_kw("as"):
                alias = lx.ident()
            else:
                k, v = lx.peek()
                if k == "word" and v.lower() not in _RESERVED_AFTER_SELECT:
                    alias = lx.ident()
            sel.items.append(SelectItem(e, alias))
        if not lx.try_op(","):
            break
    if lx.try_kw("from"):
        sel.table = _table_ref(lx)
        while True:
            if lx.try_kw("inner", "join") or lx.try_kw("join"):
                kind = "inner"
            elif lx.try_kw("left", "outer", "join") or lx.try_kw("left",
                                                                 "join"):
                kind = "left"
            else:
                break
            t = _table_ref(lx)
            on = _expr(lx) if lx.try_kw("on") else None
            sel.joins.append(Join(kind, t, on))
    if lx.try_kw("where"):
        sel.where = _expr(lx)
    if lx.try_kw("group", "by"):
        sel.group_by.append(_expr(lx))
        while lx.try_op(","):
            sel.group_by.append(_expr(lx))
    if lx.try_kw("having"):
        sel.having = _expr(lx)
    if lx.try_kw("order", "by"):
        while True:
            e = _expr(lx)
            desc = bool(lx.try_kw("desc"))
            if not desc:
                lx.try_kw("asc")
            sel.order_by.append((e, desc))
            if not lx.try_op(","):
                break
    if lx.try_kw("limit"):
        k, n = lx.next()
        sel.limit = int(n)
        if lx.try_kw("offset"):
            k, o = lx.next()
            sel.offset = int(o)
    return sel


def _table_ref(lx: Lexer) -> TableRef:
    if lx.try_op("("):
        sub = _select(lx)
        lx.expect_op(")")
        alias = None
        if lx.try_kw("as"):
            alias = lx.ident()
        elif lx.peek()[0] == "word" and \
                lx.peek()[1].lower() not in _RESERVED_AFTER_SELECT:
            alias = lx.ident()
        return TableRef(subquery=sub, alias=alias or "_sub")
    name = lx.ident()
    fn_args = None
    if lx.try_op("("):
        # table-valued function: name(arg, ...) in FROM (reference:
        # optablevaluedfunction.go plumbing; executed here)
        fn_args = []
        if not lx.try_op(")"):
            fn_args.append(_expr(lx))
            while lx.try_op(","):
                fn_args.append(_expr(lx))
            lx.expect_op(")")
    alias = None
    if lx.try_kw("as"):
        alias = lx.ident()
    elif lx.peek()[0] == "word" and \
            lx.peek()[1].lower() not in _RESERVED_AFTER_SELECT:
        alias = lx.ident()
    return TableRef(name=name, alias=alias, fn_args=fn_args)


# -- DDL --------------------------------------------------------------------------

_TYPES = {"id", "string", "idset", "stringset", "int", "decimal",
          "timestamp", "bool", "varchar"}


def _column_def(lx: Lexer):
    cname = lx.ident()
    k, t = lx.next()
    if k != "word" or t.lower() not in _TYPES:
        raise SQLError(f"bad column type {t!r}")
    t = t.lower()
    if t == "varchar":
        t = "string"
        if lx.try_op("("):
            lx.next()
            lx.expect_op(")")
    opts = {}
    if t == "decimal" and lx.try_op("("):
        k, s = lx.next()
        opts["scale"] = int(s)
        lx.expect_op(")")
    while True:
        k2, w2 = lx.peek()
        if k2 == "word" and w2.lower() in ("min", "max", "timeunit",
                                           "cachetype", "timequantum",
                                           "ttl", "size", "epoch"):
            lx.next()
            k3, v3 = lx.next()
            if w2.lower() == "min" and v3 == "-":  # negative literal
                k4, v4 = lx.next()
                v3 = -v4
            opts[w2.lower()] = v3
        elif k2 == "op" and w2 == "-":
            # e.g. MIN -100 tokenizes as op('-') then num
            break
        else:
            break
    return (cname, t, opts)


def _create(lx: Lexer):
    lx.expect_kw("create")
    if lx.try_kw("view"):
        ine = lx.try_kw("if", "not", "exists")
        name = lx.ident()
        lx.expect_kw("as")
        mark = lx.pos
        _select(lx)  # validate
        return CreateView(name, lx.span_from(mark), ine)
    if lx.try_kw("database"):
        ine = lx.try_kw("if", "not", "exists")
        name = lx.ident()
        options = {}
        while lx.try_kw("with"):
            oname = lx.ident()
            _, v = lx.next()
            options[oname.lower()] = v
        return CreateDatabase(name, options, ine)
    if lx.try_kw("function"):
        ine = lx.try_kw("if", "not", "exists")
        name = lx.ident()
        lx.expect_op("(")
        params = []
        if not lx.try_op(")"):
            while True:
                k, v = lx.peek()
                if k == "op" and v == "@":  # sql3 @param style
                    lx.next()
                pname = lx.ident()
                ptype = lx.ident()
                params.append((pname.lstrip("@"), ptype.lower()))
                if not lx.try_op(","):
                    break
            lx.expect_op(")")
        returns = "any"
        if lx.try_kw("returns"):
            returns = lx.ident().lower()
        lx.expect_kw("as")
        lx.expect_op("(")
        mark = lx.pos
        _expr(lx)  # validate
        body = lx.span_from(mark)
        lx.expect_op(")")
        return CreateFunction(name, params, returns, body, ine)
    lx.expect_kw("table")
    ine = lx.try_kw("if", "not", "exists")
    name = lx.ident()
    lx.expect_op("(")
    cols = []
    while True:
        cols.append(_column_def(lx))
        if not lx.try_op(","):
            break
    lx.expect_op(")")
    options = {}
    while lx.try_kw("with"):
        oname = lx.ident()
        k, v = lx.next()
        options[oname.lower()] = v
    if lx.try_kw("comment"):
        k, v = lx.next()
        options["comment"] = v
    return CreateTable(name, cols, ine, options)


def _alter(lx: Lexer):
    lx.expect_kw("alter")
    if lx.try_kw("view"):
        # ALTER VIEW name AS select — redefine (reference: sql3 alter
        # view, defs_views.go "alter-view")
        name = lx.ident()
        lx.expect_kw("as")
        mark = lx.pos
        _select(lx)  # validate
        return AlterView(name, lx.span_from(mark))
    lx.expect_kw("table")
    table = lx.ident()
    if lx.try_kw("add"):
        lx.try_kw("column")
        return AlterTable(table, "add", column=_column_def(lx))
    if lx.try_kw("drop"):
        lx.try_kw("column")
        return AlterTable(table, "drop", column=(lx.ident(), None, {}))
    if lx.try_kw("rename"):
        lx.expect_kw("to")
        return AlterTable(table, "rename", new_name=lx.ident())
    raise SQLError("expected ADD/DROP/RENAME after ALTER TABLE")


# -- INSERT -------------------------------------------------------------------------

def _insert(lx: Lexer, replace: bool = False) -> Insert:
    lx.next()  # insert | replace
    lx.expect_kw("into")
    table = lx.ident()
    cols = []
    if lx.try_op("("):
        while True:
            cols.append(lx.ident())
            if not lx.try_op(","):
                break
        lx.expect_op(")")
    lx.expect_kw("values")
    rows = []
    while True:
        lx.expect_op("(")
        vals = []
        while True:
            vals.append(_literal_value(lx))
            if not lx.try_op(","):
                break
        lx.expect_op(")")
        rows.append(vals)
        if not lx.try_op(","):
            break
    return Insert(table, cols, rows, replace=replace)


def _bulk_insert(lx: Lexer) -> BulkInsert:
    lx.expect_kw("bulk")
    lx.expect_kw("insert")
    lx.expect_kw("into")
    table = lx.ident()
    cols = []
    if lx.try_op("("):
        while True:
            cols.append(lx.ident())
            if not lx.try_op(","):
                break
        lx.expect_op(")")
    map_spec = None
    if lx.try_kw("map"):
        # MAP (0 ID, 1 STRING, 3 DECIMAL(2), ...) — source positions +
        # types (reference: defs_bulkinsert.go)
        lx.expect_op("(")
        map_spec = []
        while True:
            k, pos = lx.next()
            if k != "num":
                raise SQLError("MAP expects a source position")
            typ = lx.ident().lower()
            if lx.try_op("("):
                arg = lx.next()[1]
                lx.expect_op(")")
                typ = f"{typ}({arg})"
            map_spec.append((int(pos), typ))
            if not lx.try_op(","):
                break
        lx.expect_op(")")
    transform = None
    if lx.try_kw("transform"):
        # TRANSFORM (@0, @1, 'lit', ...) — source refs per target column
        lx.expect_op("(")
        transform = []
        while True:
            if lx.try_op("@"):
                k, n = lx.next()
                if k != "num":
                    raise SQLError("@ expects a position")
                transform.append(int(n))
            else:
                transform.append(("lit", _literal_value(lx)))
            if not lx.try_op(","):
                break
        lx.expect_op(")")
    lx.expect_kw("from")
    inline = False
    k, v = lx.peek()
    if k == "word" and str(v).lower() == "x":
        lx.next()  # x'...' inline stream (reference: FROM x'data')
        inline = True
    k, src = lx.next()
    if k != "str":
        raise SQLError("BULK INSERT FROM expects a quoted path or x'data'")
    fmt, header = "CSV", True
    while lx.try_kw("with"):
        while True:
            kk, w = lx.peek()
            if kk != "word":
                break
            w = str(w).lower()
            if w == "format":
                lx.next()
                k, fmt = lx.next()
            elif w == "header_row":
                lx.next()
                header = True
            elif w == "no_header_row":
                lx.next()
                header = False
            elif w == "batchsize":
                lx.next()
                lx.next()  # batch size hint: accepted, single-batch here
            elif w == "input":
                lx.next()
                k, mode = lx.next()
                if str(mode).upper() == "STREAM":
                    inline = True
            else:
                break
    if map_spec is not None:
        header = False  # mapped positions: no header inference
    return BulkInsert(table, cols, src, fmt, header,
                      map_spec=map_spec, transform=transform,
                      inline=inline)


def _literal_value(lx: Lexer):
    if lx.try_op("["):
        out = []
        if not lx.try_op("]"):
            while True:
                out.append(_literal_value(lx))
                if not lx.try_op(","):
                    break
            lx.expect_op("]")
        return out
    neg = lx.try_op("-")
    k, v = lx.next()
    if k == "num":
        return -v if neg else v
    if neg:
        raise SQLError(f"bad value -{v!r}")
    if k == "str":
        return v
    if k == "word":
        lv = v.lower()
        if lv == "null":
            return None
        if lv == "true":
            return True
        if lv == "false":
            return False
        return v
    if k == "op" and v == "[":
        pass
    raise SQLError(f"bad value {v!r}")


# -- expressions ---------------------------------------------------------------------

def _expr(lx: Lexer) -> Expr:
    node = _and_expr(lx)
    while lx.try_kw("or"):
        node = BinOp("or", node, _and_expr(lx))
    return node


def _and_expr(lx: Lexer) -> Expr:
    node = _not_expr(lx)
    while lx.try_kw("and"):
        node = BinOp("and", node, _not_expr(lx))
    return node


def _not_expr(lx: Lexer) -> Expr:
    if lx.try_kw("not"):
        return UnOp("not", _not_expr(lx))
    return _predicate(lx)


_CMP_OPS = ("<=", ">=", "<>", "!=", "=", "<", ">")


def _predicate(lx: Lexer) -> Expr:
    node = _additive(lx)
    while True:
        negated = False
        save = lx.pos
        if lx.try_kw("not"):
            negated = True
        if lx.try_kw("between"):
            lo = _additive(lx)
            lx.expect_kw("and")
            hi = _additive(lx)
            node = Between(node, lo, hi, negated)
            continue
        if lx.try_kw("in"):
            lx.expect_op("(")
            if lx.at_kw("select"):
                sub = _select(lx)
                lx.expect_op(")")
                node = InSelect(node, sub, negated)
            else:
                vals = []
                while True:
                    vals.append(_additive(lx))
                    if not lx.try_op(","):
                        break
                lx.expect_op(")")
                node = InList(node, vals, negated)
            continue
        if lx.try_kw("like"):
            k, pat = lx.next()
            if k != "str":
                raise SQLError("LIKE expects a string pattern")
            node = Like(node, pat, negated)
            continue
        if negated:
            lx.pos = save
            break
        if lx.try_kw("is"):
            neg = lx.try_kw("not")
            lx.expect_kw("null")
            node = IsNull(node, neg)
            continue
        matched = False
        for op in _CMP_OPS:
            if lx.try_op(op):
                rhs = _additive(lx)
                node = BinOp("!=" if op == "<>" else op, node, rhs)
                matched = True
                break
        if not matched:
            break
    return node


def _additive(lx: Lexer) -> Expr:
    node = _multiplicative(lx)
    while True:
        if lx.try_op("+"):
            node = BinOp("+", node, _multiplicative(lx))
        elif lx.try_op("-"):
            node = BinOp("-", node, _multiplicative(lx))
        elif lx.try_op("||"):
            node = BinOp("||", node, _multiplicative(lx))
        else:
            return node


def _multiplicative(lx: Lexer) -> Expr:
    node = _unary(lx)
    while True:
        if lx.try_op("*"):
            node = BinOp("*", node, _unary(lx))
        elif lx.try_op("/"):
            node = BinOp("/", node, _unary(lx))
        elif lx.try_op("%"):
            node = BinOp("%", node, _unary(lx))
        else:
            return node


def _unary(lx: Lexer) -> Expr:
    if lx.try_op("-"):
        return UnOp("-", _unary(lx))
    return _primary(lx)


def _primary(lx: Lexer) -> Expr:
    k, v = lx.peek()
    if k == "num":
        lx.next()
        return Lit(v)
    if k == "str":
        lx.next()
        return Lit(v)
    if k == "op" and v == "(":
        lx.next()
        if lx.at_kw("select"):
            sub = _select(lx)
            lx.expect_op(")")
            return ScalarSubquery(sub)
        node = _expr(lx)
        lx.expect_op(")")
        return node
    if k == "op" and v == "[":
        lx.next()
        vals = []
        if not lx.try_op("]"):
            while True:
                vals.append(_expr(lx))
                if not lx.try_op(","):
                    break
            lx.expect_op("]")
        return Func("tuple", vals)
    if k != "word":
        raise SQLError(f"bad expression near {v!r}")
    w = v.lower()
    if w == "null":
        lx.next()
        return Lit(None)
    if w == "true":
        lx.next()
        return Lit(True)
    if w == "false":
        lx.next()
        return Lit(False)
    if w == "case":
        return _case(lx)
    # function call?
    if lx.peek(1) == ("op", "("):
        name = lx.ident()
        lx.expect_op("(")
        if name.lower() == "cast":
            # CAST(expr AS type[(scale)]) (reference: defs_cast.go)
            arg = _expr(lx)
            lx.expect_kw("as")
            tname = lx.ident().lower()
            if lx.try_op("("):
                k2, v2 = lx.next()
                tname = f"{tname}({v2})"
                lx.expect_op(")")
            lx.expect_op(")")
            return Func("cast", [arg, Lit(tname)])
        distinct = lx.try_kw("distinct")
        args: List[Expr] = []
        if lx.try_op("*"):
            args.append(Star())
        elif not (lx.peek() == ("op", ")")):
            while True:
                args.append(_expr(lx))
                if not lx.try_op(","):
                    break
        lx.expect_op(")")
        return Func(name, args, distinct)
    # [table.]column (or qualified star: table.*)
    name = lx.ident()
    if lx.try_op("."):
        if lx.try_op("*"):
            return Star(table=name)
        return Col(lx.ident(), table=name)
    return Col(name)


def _case(lx: Lexer) -> Case:
    lx.expect_kw("case")
    operand = None
    if not lx.at_kw("when"):
        operand = _expr(lx)
    whens = []
    while lx.try_kw("when"):
        cond = _expr(lx)
        lx.expect_kw("then")
        whens.append((cond, _expr(lx)))
    else_ = _expr(lx) if lx.try_kw("else") else None
    lx.expect_kw("end")
    return Case(operand, whens, else_)
