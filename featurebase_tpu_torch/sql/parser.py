"""SQL expression parser: the hand-written lexer and the recursive-descent
expression grammar of the reference dialect (reference:
sql3/parser/parser.go, token.go).

Expression grammar (precedence low->high):
  OR < AND < NOT < predicate (cmp, IN, BETWEEN, LIKE, IS NULL)
     < additive (+ - ||) < multiplicative (* / %) < unary (-) < primary

Own copy of the lexer and expression half of featurebase_tpu/sql/parser.py,
which Apply's programs go through.  Statements, and subqueries inside an
expression, come with the SQL planner (ROADMAP.md queue 1 item 10): a
SELECT inside an expression raises SQLError here.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

from featurebase_tpu_torch.sql.ast import (Between, BinOp, Case, Col, Expr,
                                           Func, InList, IsNull, Like, Lit,
                                           Star, UnOp)

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


# -- expressions ---------------------------------------------------------------------

def _no_subquery(lx: Lexer):
    if lx.at_kw("select"):
        raise SQLError("subqueries need the SQL planner, which is not "
                       "ported yet")


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
            _no_subquery(lx)
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
        _no_subquery(lx)
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
