"""Query result types for Count and TopN (own copy of
featurebase_tpu/executor/results.py: Pair and PairsField; reference
cache.go Pair)."""
from __future__ import annotations

from typing import List, Optional


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
