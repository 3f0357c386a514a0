"""Scalar SQL functions (reference: sql3/planner/inbuiltfunctions*.go —
string/number/date built-ins).  Each takes already-evaluated Python values
and returns a Python value; None propagates unless stated.

Own copy of featurebase_tpu/sql/functions.py.
"""
from __future__ import annotations

import datetime
import math
from typing import Any, Callable, Dict, List


def _nullable(fn):
    def wrapped(*args):
        if any(a is None for a in args):
            return None
        return fn(*args)
    return wrapped


def _as_dt(v) -> datetime.datetime:
    if isinstance(v, datetime.datetime):
        return v
    if isinstance(v, (int, float)):
        return datetime.datetime.fromtimestamp(
            v, datetime.timezone.utc).replace(tzinfo=None)
    return datetime.datetime.fromisoformat(str(v).replace("Z", "+00:00")) \
        .replace(tzinfo=None)


def _datetimepart(part, v):
    dt = _as_dt(v)
    part = str(part).lower()
    table = {"yy": dt.year, "year": dt.year, "m": dt.month, "month": dt.month,
             "d": dt.day, "day": dt.day, "hh": dt.hour, "hour": dt.hour,
             "mi": dt.minute, "minute": dt.minute, "s": dt.second,
             "second": dt.second, "ms": dt.microsecond // 1000,
             "w": dt.isoweekday() % 7, "wk": dt.isocalendar()[1]}
    if part not in table:
        raise ValueError(f"bad datetimepart {part!r}")
    return table[part]


def _substring(s, start, length=None):
    s = str(s)
    start = int(start)
    if length is None:
        return s[start:]
    return s[start:start + int(length)]


def _round(x, digits=0):
    return round(float(x), int(digits)) if digits else float(round(float(x)))


def _setcontains(s, v) -> bool:
    if s is None:
        return False
    return v in s if isinstance(s, (list, set, tuple)) else s == v


def _setcontainsany(s, vals) -> bool:
    if s is None or vals is None:
        return False
    ss = s if isinstance(s, (list, set, tuple)) else [s]
    return any(v in ss for v in vals)


def _setcontainsall(s, vals) -> bool:
    if s is None or vals is None:
        return False
    ss = s if isinstance(s, (list, set, tuple)) else [s]
    return all(v in ss for v in vals)


FUNCTIONS: Dict[str, Callable[..., Any]] = {
    # string (reference: inbuiltfunctionsstring.go)
    "upper": _nullable(lambda s: str(s).upper()),
    "lower": _nullable(lambda s: str(s).lower()),
    "char_length": _nullable(lambda s: len(str(s))),
    "len": _nullable(lambda s: len(str(s))),
    "ltrim": _nullable(lambda s: str(s).lstrip()),
    "rtrim": _nullable(lambda s: str(s).rstrip()),
    "trim": _nullable(lambda s: str(s).strip()),
    "reverse": _nullable(lambda s: str(s)[::-1]),
    "substring": _nullable(_substring),
    "replaceall": _nullable(lambda s, a, b: str(s).replace(str(a), str(b))),
    "replace": _nullable(lambda s, a, b: str(s).replace(str(a), str(b))),
    "stringsplit": _nullable(
        lambda s, sep, idx=0: (str(s).split(str(sep)) + [None] * 99)[int(idx)]),
    "format": _nullable(lambda fmt, *a: str(fmt).format(*a)),
    "space": _nullable(lambda n: " " * int(n)),
    "prefix": _nullable(lambda s, n: str(s)[: int(n)]),
    "suffix": _nullable(lambda s, n: str(s)[-int(n):]),
    "str": _nullable(lambda v: str(v)),
    "ascii": _nullable(lambda s: ord(str(s)[0]) if str(s) else None),
    "char": _nullable(lambda n: chr(int(n))),
    "chr": _nullable(lambda n: chr(int(n))),
    "charindex": _nullable(
        lambda sub, s, start=0: str(s).find(str(sub), int(start))),
    "replicate": _nullable(lambda s, n: str(s) * int(n)),
    # number (reference: inbuiltfunctionsnumber.go)
    "abs": _nullable(lambda x: abs(x)),
    "ceil": _nullable(lambda x: math.ceil(x)),
    "floor": _nullable(lambda x: math.floor(x)),
    "round": _nullable(_round),
    "sqrt": _nullable(lambda x: math.sqrt(x)),
    "power": _nullable(lambda x, y: x ** y),
    "pow": _nullable(lambda x, y: x ** y),
    "mod": _nullable(lambda x, y: x % y),
    "sign": _nullable(lambda x: (x > 0) - (x < 0)),
    "log": _nullable(lambda x: math.log(x)),
    "log10": _nullable(lambda x: math.log10(x)),
    "exp": _nullable(lambda x: math.exp(x)),
    "sin": _nullable(math.sin), "cos": _nullable(math.cos),
    "tan": _nullable(math.tan), "atan": _nullable(math.atan),
    "int": _nullable(lambda v: int(v)),
    # date/time (reference: inbuiltfunctionsdatetime.go)
    "datetimepart": _nullable(_datetimepart),
    "datetimename": _nullable(
        lambda part, v: _as_dt(v).strftime(
            {"month": "%B", "m": "%B", "day": "%A", "d": "%A"}
            .get(str(part).lower(), "%c"))),
    "dateadd": _nullable(lambda part, n, v: _date_add(part, n, v)),
    "totimestamp": _nullable(lambda v, unit="s": _as_dt(
        float(v) * {"s": 1, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}
        [str(unit)]).isoformat()),
    "datetimediff": _nullable(lambda part, a, b: _datetime_diff(part, a, b)),
    "datetimefromparts": _nullable(
        lambda y, mo, d, h=0, mi=0, s=0, ms=0: datetime.datetime(
            int(y), int(mo), int(d), int(h), int(mi), int(s),
            int(ms) * 1000).isoformat()),
    "datetrunc": _nullable(lambda part, v: _date_trunc(part, v)),
    # set helpers (reference: inbuiltfunctionsset.go)
    "setcontains": _setcontains,
    "setcontainsany": _setcontainsany,
    "setcontainsall": _setcontainsall,
    # misc
    "cast": lambda v, t: _cast(v, t),
    "coalesce": lambda *a: next((x for x in a if x is not None), None),
    "nullif": _nullable(lambda a, b: None if a == b else a),
    "iif": lambda c, a, b: a if c else b,
    "greatest": _nullable(lambda *a: max(a)),
    "least": _nullable(lambda *a: min(a)),
}


def _date_add(part, n, v):
    dt = _as_dt(v)
    part = str(part).lower()
    n = int(n)
    if part in ("yy", "year"):
        return dt.replace(year=dt.year + n).isoformat()
    if part in ("m", "month"):
        month = dt.month - 1 + n
        return dt.replace(year=dt.year + month // 12,
                          month=month % 12 + 1).isoformat()
    delta = {"d": "days", "day": "days", "hh": "hours", "hour": "hours",
             "mi": "minutes", "minute": "minutes", "s": "seconds",
             "second": "seconds", "ms": "milliseconds"}[part]
    return (dt + datetime.timedelta(**{delta: n})).isoformat()


def _cast(v, t):
    """CAST(expr AS type) (reference: defs_cast.go semantics — int
    truncates toward zero, bool <-> 0/1, timestamp from epoch seconds,
    sets wrap scalars)."""
    if v is None:
        return None
    t = str(t).lower()
    base, _, scale = t.partition("(")
    base = base.strip()
    if base in ("int", "id", "long"):
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, str):
            return int(float(v.strip())) if "." in v else int(v.strip())
        return int(v)
    if base == "bool":
        if isinstance(v, str):
            return v.strip().lower() in ("true", "t", "1")
        return bool(v)
    if base == "decimal":
        s = int(scale.rstrip(")")) if scale else 0
        return round(float(v), s)
    if base in ("float", "double"):
        return float(v)
    if base in ("string", "varchar"):
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, list):
            return "[" + ",".join(str(x) for x in v) + "]"
        return str(v)
    if base == "stringset":
        vals = v if isinstance(v, (list, tuple, set)) else [v]
        return [str(x) for x in vals]
    if base == "idset":
        vals = v if isinstance(v, (list, tuple, set)) else [v]
        return [int(x) for x in vals]
    if base == "timestamp":
        if isinstance(v, bool):
            raise ValueError("cannot cast bool to timestamp")
        return _as_dt(v).isoformat()
    raise ValueError(f"cannot cast to {t!r}")


def _datetime_diff(part, a, b):
    """Whole units from a to b (reference: analyzeFunctionDateTimeDiff)."""
    da, db = _as_dt(a), _as_dt(b)
    part = str(part).lower()
    if part in ("yy", "year"):
        return db.year - da.year
    if part in ("m", "month"):
        return (db.year - da.year) * 12 + (db.month - da.month)
    secs = (db - da).total_seconds()
    return int(secs / {"d": 86400, "day": 86400, "hh": 3600, "hour": 3600,
                       "mi": 60, "minute": 60, "s": 1, "second": 1,
                       "ms": 1e-3, "us": 1e-6, "ns": 1e-9}[part])


def _date_trunc(part, v):
    dt = _as_dt(v)
    part = str(part).lower()
    if part in ("yy", "year"):
        return dt.replace(month=1, day=1, hour=0, minute=0, second=0,
                          microsecond=0).isoformat()
    if part in ("m", "month"):
        return dt.replace(day=1, hour=0, minute=0, second=0,
                          microsecond=0).isoformat()
    if part in ("d", "day"):
        return dt.replace(hour=0, minute=0, second=0,
                          microsecond=0).isoformat()
    if part in ("hh", "hour"):
        return dt.replace(minute=0, second=0, microsecond=0).isoformat()
    if part in ("mi", "minute"):
        return dt.replace(second=0, microsecond=0).isoformat()
    if part in ("s", "second"):
        return dt.replace(microsecond=0).isoformat()
    raise ValueError(f"bad datetrunc part {part!r}")


def call_function(name: str, args: List[Any]):
    fn = FUNCTIONS.get(name)
    if fn is None:
        raise ValueError(f"unknown function {name}()")
    return fn(*args)
