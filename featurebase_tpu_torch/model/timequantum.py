"""Time-quantum view naming and range covering.

Mirrors the reference's time.go (reference: time.go:20-120 TimeQuantum,
viewsByTime, viewByTimeUnit; field.go:1063 viewsByTimeRange): a time field
with quantum Q ⊆ "YMDH" materializes, for every set bit at timestamp t, one
view per unit in Q named `standard_YYYY[MM[DD[HH]]]`.  Ranged queries are
answered by a minimal greedy cover of [from, to) using the coarsest available
units.
"""
from __future__ import annotations

from datetime import datetime, timedelta
from typing import List

VIEW_STANDARD = "standard"

_UNITS = "YMDH"
_FMT = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    return f"{name}_{t.strftime(_FMT[unit])}"


def views_by_time(name: str, t: datetime, q: str) -> List[str]:
    """All views a bit at timestamp t lands in (reference time.go viewsByTime)."""
    return [view_by_time_unit(name, t, u) for u in q]


def _trunc(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return t.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "M":
        return t.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "D":
        return t.replace(hour=0, minute=0, second=0, microsecond=0)
    return t.replace(minute=0, second=0, microsecond=0)


def _next(t: datetime, unit: str) -> datetime:
    if unit == "Y":
        return t.replace(year=t.year + 1)
    if unit == "M":
        if t.month == 12:
            return t.replace(year=t.year + 1, month=1)
        return t.replace(month=t.month + 1)
    if unit == "D":
        return t + timedelta(days=1)
    return t + timedelta(hours=1)


def view_time_range(view_name: str):
    """Parse a time view name (e.g. 'standard_2022', 'standard_20220314')
    into its (start, end) datetimes, or None for non-time views (reference:
    server.go:920 ViewsRemoval parses view names the same way)."""
    _, _, suffix = view_name.rpartition("_")
    if not suffix.isdigit():
        return None
    unit = {4: "Y", 6: "M", 8: "D", 10: "H"}.get(len(suffix))
    if unit is None:
        return None
    try:
        start = datetime.strptime(suffix, _FMT[unit])
    except ValueError:
        return None
    return start, _next(start, unit)


def views_by_time_range(name: str, from_t: datetime, to_t: datetime,
                        q: str) -> List[str]:
    """Minimal set of views covering [from_t, to_t) (reference field.go:1063).

    Bounds are truncated to the finest unit present in the quantum.
    """
    if not q:
        return []
    units = [u for u in _UNITS if u in q]  # coarse -> fine
    fine = units[-1]
    t = _trunc(from_t, fine)
    end = _trunc(to_t, fine)
    views: List[str] = []
    while t < end:
        chosen = None
        for u in units:  # coarsest first
            if _trunc(t, u) == t and _next(t, u) <= end:
                chosen = u
                break
        if chosen is None:
            chosen = fine
        views.append(view_by_time_unit(name, t, chosen))
        t = _next(t, chosen)
    return views


def parse_time(v) -> datetime:
    """Parse PQL time literals (reference pql supports RFC3339-ish forms)."""
    if isinstance(v, datetime):
        return v
    if isinstance(v, (int, float)):
        return datetime.utcfromtimestamp(v)
    s = str(v)
    for fmt in ("%Y-%m-%dT%H:%M:%S.%fZ", "%Y-%m-%dT%H:%M:%SZ",
                "%Y-%m-%dT%H:%M:%S", "%Y-%m-%dT%H:%M", "%Y-%m-%d",
                "%Y-%m-%dT%H", "%Y%m%d%H", "%Y%m%d"):
        try:
            return datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ValueError(f"cannot parse time literal {v!r}")
