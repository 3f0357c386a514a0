"""Entries the port's device residency LRU (storage/residency.py) evicted
in the window."""


def read(ctx):
    if ctx.residency is None:
        return None
    before, after = ctx.residency
    return float(after["evictions"] - before["evictions"])
