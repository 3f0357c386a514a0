"""The port's answers in the reference's canonical form
(portbench/reference/answers.py), and the comparison that decides
`correct`: every compared answer equal to the reference's, no query
failed, and at least MIN_COMPARED answers compared."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

# A run compares at least this many answers (a share of the window's
# queries drawn from the seed), or it is not correct.
MIN_COMPARED = 20


def groups_bytes(groups: dict) -> bytes:
    """A GroupBy's {(row id, ...): (count, sum)} as the bytes of an int64
    array of its rows (row ids, count, sum) in key order: one object, so
    that answers kept through the window add nothing for the collector to
    walk."""
    rows = [list(k) + list(v) for k, v in sorted(groups.items())]
    return np.asarray(rows, dtype=np.int64).tobytes()


def canonical(q: dict, result):
    """The result of one PQL call (API.query's first result) in the form
    the reference's answer takes (reference/answers.py), read by attribute:
    GroupCount.group[i].row_id, .count, .agg; ValCount.val, .count; a
    Count's int."""
    if "groupby" in q:
        return groups_bytes({tuple(int(fr.row_id) for fr in gc.group):
                             (int(gc.count), int(gc.agg or 0))
                             for gc in result})
    if "sum" in q:
        return (int(result.val), int(result.count))
    return int(result)


def reference_form(q: dict, answer):
    """The reference's answer in the form canonical() gives."""
    return groups_bytes(answer) if "groupby" in q else answer


def checks(records, ref: Dict[tuple, object]) -> List[dict]:
    """The numbers compared, each with its limit, in printing order.
    `records` are the window's (loop.Record), `ref` the reference's answer
    by query spec."""
    kept = [r for r in records if r.answer is not None]
    wrong = sum(1 for r in kept if r.answer != ref[r.query.spec])
    failed = sum(1 for r in records if r.error is not None)
    return [
        {"name": "wrong_answers", "value": wrong, "limit": 0, "op": "<="},
        {"name": "failed_queries", "value": failed, "limit": 0, "op": "<="},
        {"name": "answers_compared", "value": len(kept),
         "limit": MIN_COMPARED, "op": ">="},
    ]


def passed(check: dict) -> bool:
    if check["op"] == "<=":
        return check["value"] <= check["limit"]
    return check["value"] >= check["limit"]
