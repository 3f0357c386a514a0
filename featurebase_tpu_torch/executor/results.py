"""Query result types (own copy of featurebase_tpu/executor/results.py:
ValCount for Sum/Min/Max, Pair and PairsField for TopN, PairField for
MinRow/MaxRow, FieldRow and GroupCount for GroupBy, and the Extracted*
types of Extract; reference executor.go ValCount, FieldRow, GroupCount,
ExtractedIDMatrix, ExtractedTable, cache.go Pair)."""
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


class ExtractedIDColumn:
    __slots__ = ("column", "rows")

    def __init__(self, column: int, rows: List[List[int]]):
        self.column = column
        self.rows = rows


class ExtractedIDMatrix:
    """Per-shard Extract result before key translation (reference
    executor.go ExtractedIDMatrix)."""

    __slots__ = ("fields", "columns")

    def __init__(self, fields: List[str], columns: List[ExtractedIDColumn]):
        self.fields = fields
        self.columns = columns

    def append(self, other: "ExtractedIDMatrix"):
        self.columns.extend(other.columns)


class ExtractedTableField:
    __slots__ = ("name", "type")

    def __init__(self, name: str, type: str):
        self.name = name
        self.type = type


class ExtractedTableColumn:
    __slots__ = ("column", "rows")

    def __init__(self, column, rows: List[Any]):
        self.column = column
        self.rows = rows


class ExtractedTable:
    """Tabular Extract result, columnar first (reference arrow.go:366
    per-shard streaming): the executor fills `col_ids` (record ids or keys,
    sorted) and `field_values` (one parallel value list per field); the
    per-record `columns` view is built only when a consumer asks for it."""

    __slots__ = ("fields", "_columns", "col_ids", "field_values")

    def __init__(self, fields: List[ExtractedTableField],
                 columns: Optional[List[ExtractedTableColumn]] = None,
                 col_ids: Optional[list] = None,
                 field_values: Optional[list] = None):
        self.fields = fields
        self._columns = columns
        self.col_ids = col_ids if col_ids is not None else \
            (None if columns is not None else [])
        self.field_values = field_values

    @property
    def columns(self) -> List[ExtractedTableColumn]:
        if self._columns is None:
            cids = self.col_ids or []
            if self.field_values:
                self._columns = [
                    ExtractedTableColumn(c, list(vs))
                    for c, vs in zip(cids, zip(*self.field_values))]
            else:
                self._columns = [ExtractedTableColumn(c, [])
                                 for c in cids]
        return self._columns

    @columns.setter
    def columns(self, v: List[ExtractedTableColumn]):
        self._columns = v
        self.col_ids = None
        self.field_values = None

    def __len__(self):
        if self.col_ids is not None:
            return len(self.col_ids)
        return len(self._columns or ())

    def to_json(self):
        fields = [{"name": f.name, "type": f.type} for f in self.fields]
        if self._columns is None and self.col_ids is not None:
            if self.field_values:
                cols = [{"column": c, "rows": list(vs)}
                        for c, vs in zip(self.col_ids,
                                         zip(*self.field_values))]
            else:
                cols = [{"column": c, "rows": []} for c in self.col_ids]
        else:
            cols = [{"column": c.column, "rows": c.rows}
                    for c in self.columns]
        return {"fields": fields, "columns": cols}
