"""A part of the date that lies `of` days after `start`: `year`,
`yearmonthnum` (YYYYMM) or `weeknuminyear` ((day of year - 1) // 7 + 1)."""
import datetime
import functools

import torch


@functools.lru_cache(maxsize=None)
def _table(start: str, part: str, days: int) -> tuple:
    d0 = datetime.date.fromisoformat(start)
    out = []
    for i in range(days):
        d = d0 + datetime.timedelta(days=i)
        if part == "year":
            out.append(d.year)
        elif part == "yearmonthnum":
            out.append(d.year * 100 + d.month)
        elif part == "weeknuminyear":
            out.append((d.timetuple().tm_yday - 1) // 7 + 1)
        else:
            raise ValueError(f"unknown calendar part {part!r}")
    return tuple(out)


def generate(spec, n, gen, cols, device):
    day = cols[spec["of"]]
    days = int(day.max()) + 1 if n else 1
    table = torch.tensor(_table(spec["start"], spec["part"], days),
                         dtype=torch.int64, device=device)
    return table[day]
