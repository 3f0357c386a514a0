"""PQL AST types (reference: pql/ast.go:18 Query, Call; Condition ast.go:374)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional


class Condition:
    """A comparison attached to a field argument.

    op in {'==','!=','<','<=','>','>=','betw'}; for 'betw' value is a
    two-element [lo, hi] with lo_strict/hi_strict recording whether each bound
    is exclusive (from `a < f < b` conditional syntax; the `><` operator is
    inclusive-inclusive, matching reference BETWEEN semantics).
    """

    __slots__ = ("op", "value", "lo_strict", "hi_strict")

    def __init__(self, op: str, value: Any, lo_strict: bool = False,
                 hi_strict: bool = False):
        self.op = op
        self.value = value
        self.lo_strict = lo_strict
        self.hi_strict = hi_strict

    def __repr__(self):
        if self.op == "betw":
            l = "<" if self.lo_strict else "<="
            h = "<" if self.hi_strict else "<="
            return f"Cond({self.value[0]} {l} x {h} {self.value[1]})"
        return f"Cond(x {self.op} {self.value})"

    def __eq__(self, other):
        return (isinstance(other, Condition) and self.op == other.op
                and self.value == other.value
                and self.lo_strict == other.lo_strict
                and self.hi_strict == other.hi_strict)


class Variable:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"${self.name}"

    def __eq__(self, other):
        return isinstance(other, Variable) and self.name == other.name

    def __hash__(self):
        return hash(("$var", self.name))


class Call:
    """A PQL function call: name, keyword args, child calls.

    Positional args use reserved keys: _field, _col, _timestamp, _ivy,
    _ivyReduce (reference pql.peg posfield/col/time rules).
    """

    __slots__ = ("name", "args", "children")

    def __init__(self, name: str, args: Optional[Dict[str, Any]] = None,
                 children: Optional[List["Call"]] = None):
        self.name = name
        self.args = args or {}
        self.children = children or []

    def arg(self, key: str, default=None):
        return self.args.get(key, default)

    def field_arg(self):
        """The single field=value or field-condition argument for row calls
        (reference executor uses Call.FieldArg)."""
        reserved = {"from", "to", "_field", "_col", "_timestamp", "like",
                    "in", "previous", "limit", "column", "valueidx", "_ivy",
                    "_ivyReduce"}
        for k, v in self.args.items():
            if k not in reserved:
                return k, v
        return None, None

    def __repr__(self):
        parts = [repr(c) for c in self.children]
        parts += [f"{k}={v!r}" for k, v in self.args.items()]
        return f"{self.name}({', '.join(parts)})"

    def signature(self):
        """Structural key for plan caching: ignores literal values, keeps
        shape (name, sorted arg keys, child signatures)."""
        return (self.name, tuple(sorted(self.args)),
                tuple(c.signature() for c in self.children))


class Query:
    __slots__ = ("calls",)

    def __init__(self, calls: List[Call]):
        self.calls = calls

    def __repr__(self):
        return "; ".join(repr(c) for c in self.calls)



# calls that write (reference: executor.go executeCall write dispatch); a
# query holding one runs under its index's mutate gate, not a snapshot pin
WRITE_CALLS = {"Set", "Clear", "ClearRow", "Store", "Delete"}
