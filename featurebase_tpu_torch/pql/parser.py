"""Recursive-descent PQL parser.

Implements the reference grammar (reference: pql/pql.peg:1-104) directly as a
hand-written parser instead of a generated PEG machine (reference pql.peg.go).
Covers: calls with child calls and keyword args, positional col/field/time,
conditions (==, !=, <, <=, >, >=, ><), conditional triples (a < f < b),
lists, strings, decimals, booleans, null, variables, and timestamp literals.
"""
from __future__ import annotations

import re
from typing import Any, Optional, Tuple

from featurebase_tpu_torch.pql.ast import Call, Condition, Query, Variable

_TS_FULL = re.compile(
    r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d:\d\d(\.\d+)?(Z|[+-]\d\d:\d\d)")
_TS_MINUTE = re.compile(r"\d{4}-[01]\d-[0-3]\dT\d\d:\d\d")
_IDENT = re.compile(r"[A-Za-z][A-Za-z0-9Θ]*")
_FIELD = re.compile(r"[A-Za-z_$][A-Za-z0-9_\-Θ]*")
_DECIMAL = re.compile(r"-?(\d+(\.\d*)?|\.\d+)")
_BAREWORD = re.compile(r"[A-Za-z0-9\-_:Θ]+")
_DIGITS = re.compile(r"\d+")

# calls whose first positional token is a column (reference pql.peg Set/Clear)
_COL_CALLS = {"Set", "Clear"}
# calls whose first positional token is a field name
_POSFIELD_CALLS = {"TopN", "TopK", "Percentile", "Rows", "Min", "Max", "Sum",
                   "Distinct"}


class ParseError(Exception):
    pass


class Parser:
    def __init__(self, src: str):
        self.s = src
        self.i = 0

    # -- low level -----------------------------------------------------------

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t\n\r":
            self.i += 1

    def _peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def _expect(self, ch: str):
        self._ws()
        if not self.s.startswith(ch, self.i):
            raise ParseError(f"expected {ch!r} at {self.i}: "
                             f"...{self.s[self.i:self.i+24]!r}")
        self.i += len(ch)

    def _try(self, ch: str) -> bool:
        self._ws()
        if self.s.startswith(ch, self.i):
            self.i += len(ch)
            return True
        return False

    def _match(self, rx) -> Optional[str]:
        self._ws()
        m = rx.match(self.s, self.i)
        if m:
            self.i = m.end()
            return m.group(0)
        return None

    def _string(self) -> Optional[str]:
        self._ws()
        q = self._peek()
        if q not in "'\"":
            return None
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise ParseError("unterminated string")
            c = self.s[self.i]
            if c == "\\" and self.i + 1 < len(self.s):
                nxt = self.s[self.i + 1]
                out.append({"n": "\n", "t": "\t"}.get(nxt, nxt))
                self.i += 2
                continue
            if c == q:
                self.i += 1
                return "".join(out)
            out.append(c)
            self.i += 1

    # -- grammar -------------------------------------------------------------

    def parse(self) -> Query:
        calls = []
        self._ws()
        while self.i < len(self.s):
            calls.append(self.call())
            self._ws()
        return Query(calls)

    def call(self) -> Call:
        name = self._match(_IDENT)
        if name is None:
            raise ParseError(f"expected call at {self.i}")
        self._expect("(")
        call = Call(name)
        if name in _COL_CALLS:
            self._col(call)
            if self._try(","):
                self._args(call)
        elif name == "Store":
            call.children.append(self.call())
            self._expect(",")
            self._args(call)
        elif name == "Apply":
            save = self.i
            try:
                call.children.append(self.call())
                self._expect(",")
            except ParseError:
                self.i = save
                call.children = []
            prog = self._string()
            if prog is not None:
                call.args["_ivy"] = prog
                if self._try(","):
                    call.args["_ivyReduce"] = self._string()
        elif name in _POSFIELD_CALLS:
            save = self.i
            fld = self._string()
            if fld is None:
                if self._try("field="):
                    pass
                fld = self._match(_FIELD)
            if fld is not None and (self._peek_is("(") or
                                    (self._peek_is("=") and
                                     not self._peek_is("=="))):
                # posfield actually begins a child call or a named arg
                # (e.g. filter=Row(...)) — backtrack to the generic rule
                # (PEG ordered-choice fallback, pql.peg:23)
                self.i = save
                self._allargs(call)
            elif fld is not None:
                call.args["_field"] = fld
                if self._try(","):
                    self._allargs(call)
            else:
                self._allargs(call)
        else:
            self._allargs(call)
        self._try(",")
        self._expect(")")
        return call

    def _col(self, call: Call):
        s = self._string()
        if s is not None:
            call.args["_col"] = s
            return
        d = self._match(_DIGITS)
        if d is None:
            raise ParseError(f"expected column at {self.i}")
        call.args["_col"] = int(d)

    def _allargs(self, call: Call):
        self._ws()
        if self._peek() == ")":
            return
        # try child call(s) first: IDENT followed by '('
        while True:
            save = self.i
            name = self._match(_IDENT)
            if name is not None and self._peek_is("("):
                self.i = save
                call.children.append(self.call())
                if self._try(","):
                    continue
                return
            self.i = save
            break
        self._args(call)

    def _peek_is(self, ch: str) -> bool:
        self._ws()
        return self.s.startswith(ch, self.i)

    def _args(self, call: Call):
        while True:
            self._ws()
            if self._peek() == ")" or self.i >= len(self.s):
                return
            self._arg(call)
            if not self._try(","):
                return

    def _arg(self, call: Call):
        # conditional triple: value < field < value
        save = self.i
        cond = self._try_conditional()
        if cond is not None:
            fld, c = cond
            call.args[fld] = c
            return
        self.i = save
        # field (= | COND) value  — also allow `Set(col, f=v, ts)` trailing
        # timestamp position (grammar `(comma time)?`)
        ts = self._match(_TS_MINUTE)
        if ts is not None and not self._peek_is("=") and not self._peek_is("<"):
            call.args["_timestamp"] = ts
            return
        self.i = save
        fld = self._match(_FIELD)
        if fld is None:
            # quoted timestamp in Set position
            s = self._string()
            if s is not None and _TS_MINUTE.match(s):
                call.args["_timestamp"] = s
                return
            raise ParseError(f"expected argument at {self.i}")
        self._ws()
        for op in ("><", "<=", ">=", "==", "!=", "<", ">"):
            if self.s.startswith(op, self.i):
                self.i += len(op)
                val = self.value()
                if op == "><":
                    call.args[fld] = Condition("betw", val)
                else:
                    call.args[fld] = Condition(op if op in
                                               ("==", "!=", "<=", ">=") else op,
                                               val)
                return
        self._expect("=")
        call.args[fld] = self.value()

    def _try_conditional(self) -> Optional[Tuple[str, Condition]]:
        """`a <(=) field <(=) b` (reference pql.peg conditional rule)."""
        lo = self._cond_scalar()
        if lo is None:
            return None
        op1 = "<=" if self._try("<=") else ("<" if self._try("<") else None)
        if op1 is None:
            return None
        fld = self._match(_FIELD)
        if fld is None:
            return None
        op2 = "<=" if self._try("<=") else ("<" if self._try("<") else None)
        if op2 is None:
            return None
        hi = self._cond_scalar()
        if hi is None:
            return None
        return fld, Condition("betw", [lo, hi],
                              lo_strict=(op1 == "<"),
                              hi_strict=(op2 == "<"))

    def _cond_scalar(self):
        ts = self._match(_TS_FULL)
        if ts:
            return ts
        d = self._match(_DECIMAL)
        if d is not None:
            return self._num(d)
        return None

    @staticmethod
    def _num(text: str):
        if "." in text:
            return float(text)
        return int(text)

    def value(self) -> Any:
        self._ws()
        if self._try("["):
            items = []
            self._ws()
            if not self._try("]"):
                while True:
                    items.append(self.value())
                    if not self._try(","):
                        break
                self._expect("]")
            return items
        return self._item()

    def _item(self) -> Any:
        self._ws()
        # keyword literals (must be followed by , or ))
        for lit, val in (("null", None), ("true", True), ("false", False)):
            if self.s.startswith(lit, self.i):
                j = self.i + len(lit)
                k = j
                while k < len(self.s) and self.s[k] in " \t\n":
                    k += 1
                if k >= len(self.s) or self.s[k] in ",)]":
                    self.i = j
                    return val
        if self._try("$"):
            name = self._match(_FIELD)
            return Variable(name)
        ts = self._match(_TS_FULL)
        if ts:
            return ts
        tm = self._match(_TS_MINUTE)
        if tm:
            return tm
        save = self.i
        d = self._match(_DECIMAL)
        if d is not None:
            # ensure not an identifier like 1abc — bareword fallback
            if self.i < len(self.s) and re.match(r"[A-Za-z_:\-]", self.s[self.i]):
                self.i = save
            else:
                return self._num(d)
        save = self.i
        ident = self._match(_IDENT)
        if ident is not None and self._peek_is("("):
            self.i = save
            return self.call()
        self.i = save
        s = self._string()
        if s is not None:
            return s
        w = self._match(_BAREWORD)
        if w is not None:
            return w
        raise ParseError(f"expected value at {self.i}: "
                         f"...{self.s[self.i:self.i+24]!r}")


def parse(src: str) -> Query:
    return Parser(src).parse()
