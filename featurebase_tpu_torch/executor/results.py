"""Query result types (own copy of featurebase_tpu/executor/results.py:
ValCount for Sum/Min/Max, Pair and PairsField for TopN, PairField for
MinRow/MaxRow, FieldRow and GroupCount for GroupBy; reference executor.go
ValCount, FieldRow, GroupCount, cache.go Pair)."""
from __future__ import annotations

from typing import Any, Dict, List, Optional


class ValCount:
    """Aggregate result (reference ValCount; Sum/Min/Max)."""

    __slots__ = ("val", "count", "float_val", "decimal_val", "timestamp_val")

    def __init__(self, val: int = 0, count: int = 0,
                 float_val: Optional[float] = None,
                 decimal_val=None, timestamp_val=None):
        self.val = val
        self.count = count
        self.float_val = float_val
        self.decimal_val = decimal_val
        self.timestamp_val = timestamp_val

    def add(self, other: "ValCount") -> "ValCount":
        return ValCount(self.val + other.val, self.count + other.count)

    def smaller(self, other: "ValCount") -> "ValCount":
        """Merge for Min: the smaller value, counts summed on a tie
        (reference ValCount.Smaller)."""
        if other.count == 0:
            return self
        if self.count == 0 or other.val < self.val:
            return other
        if other.val == self.val:
            return ValCount(self.val, self.count + other.count,
                            self.float_val, self.decimal_val,
                            self.timestamp_val)
        return self

    def larger(self, other: "ValCount") -> "ValCount":
        if other.count == 0:
            return self
        if self.count == 0 or other.val > self.val:
            return other
        if other.val == self.val:
            return ValCount(self.val, self.count + other.count,
                            self.float_val, self.decimal_val,
                            self.timestamp_val)
        return self

    def __eq__(self, other):
        if isinstance(other, tuple):
            return (self.val, self.count) == other
        return (isinstance(other, ValCount) and self.val == other.val
                and self.count == other.count)

    def __repr__(self):
        return f"ValCount(val={self.val}, count={self.count})"


class Pair:
    """(row id|key, count) for TopN/TopK (reference cache.go Pair)."""

    __slots__ = ("id", "key", "count")

    def __init__(self, id: int = 0, count: int = 0, key: Optional[str] = None):
        self.id = id
        self.key = key
        self.count = count

    def __eq__(self, other):
        if isinstance(other, tuple):
            return (self.id, self.count) == other
        return (isinstance(other, Pair) and self.id == other.id
                and self.count == other.count and self.key == other.key)

    def __repr__(self):
        return f"Pair({self.key if self.key is not None else self.id}, {self.count})"


class PairsField:
    __slots__ = ("pairs", "field")

    def __init__(self, pairs: List[Pair], field: str):
        self.pairs = pairs
        self.field = field

    def __repr__(self):
        return f"PairsField({self.field}, {self.pairs})"


class PairField:
    """MinRow/MaxRow result: one (row id, count) pair of a field."""

    __slots__ = ("pair", "field")

    def __init__(self, pair: Pair, field: str):
        self.pair = pair
        self.field = field

    def __repr__(self):
        return f"PairField({self.field}, {self.pair})"


class FieldRow:
    """One grouping key element (reference executor.go FieldRow)."""

    __slots__ = ("field", "row_id", "row_key", "value")

    def __init__(self, field: str, row_id: int = 0,
                 row_key: Optional[str] = None, value: Optional[int] = None):
        self.field = field
        self.row_id = row_id
        self.row_key = row_key
        self.value = value

    def to_json(self):
        out: Dict[str, Any] = {"field": self.field}
        if self.value is not None:
            out["value"] = self.value
        elif self.row_key is not None:
            out["rowKey"] = self.row_key
        else:
            out["rowID"] = self.row_id
        return out

    def __repr__(self):
        v = self.value if self.value is not None else \
            (self.row_key if self.row_key is not None else self.row_id)
        return f"{self.field}={v}"


class GroupCount:
    """One GroupBy group: its key, count and aggregate (reference
    executor.go GroupCount)."""

    __slots__ = ("group", "count", "agg", "decimal_agg")

    def __init__(self, group: List[FieldRow], count: int = 0, agg: int = 0,
                 decimal_agg: Optional[float] = None):
        self.group = group
        self.count = count
        self.agg = agg
        self.decimal_agg = decimal_agg

    def to_json(self):
        out = {"group": [g.to_json() for g in self.group], "count": self.count}
        if self.agg:
            out["sum"] = self.agg
        if self.decimal_agg is not None:
            out["decimalSum"] = self.decimal_agg
        return out

    def __repr__(self):
        return f"GroupCount({self.group}, count={self.count}, agg={self.agg})"
