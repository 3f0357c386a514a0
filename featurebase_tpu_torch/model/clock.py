"""Write clocks: one a fragment, view, field and index, so that a device
cache gathered from a field's fragments can tell in O(1) that none of them
changed (executor/plan.py's stacked leaves) and a snapshot pin that none of
the index's did (model/snapshot.py).

A change bumps the clock of the object that holds the state and each clock
above it: a fragment's generation moving (``Fragment.__setattr__``), a
fragment installed in or removed from a view's ``fragments``, a view in or
from a field's ``views``, a field in or from an index's ``fields``
(``ClockedDict``).  The bump comes after the change, so a reading taken
before a walk of the fragments is stale whenever the walk may have missed
the change.  A bump gives each clock on the way up a value drawn once from
one process-wide counter: no clock shows a value twice and no two clocks
show the same value, so a reading equals a clock's value later only if it
was read from that clock and nothing under it changed since.  ``next`` on
an itertools.count is atomic, so two concurrent writers never fold their
bumps into one.
"""
from __future__ import annotations

import itertools

_TICKS = itertools.count(1)


class Clock:
    """A write clock: `value` moves at each bump under it; `parent` is the
    clock of the container it was last installed in."""

    __slots__ = ("value", "parent")

    def __init__(self):
        self.value = next(_TICKS)
        self.parent = None

    def bump(self) -> None:
        c = self
        while c is not None:
            c.value = next(_TICKS)
            c = c.parent


class ClockedDict(dict):
    """A dict of clocked objects (each with a ``clock``) whose installs and
    removals bump `clock`; an installed object's clock hangs under it.  It
    is changed only by item assignment, ``del``, ``pop`` and ``clear``."""

    __slots__ = ("clock",)

    def __init__(self, clock: Clock):
        super().__init__()
        self.clock = clock

    def __setitem__(self, key, value):
        value.clock.parent = self.clock
        super().__setitem__(key, value)
        self.clock.bump()

    def __delitem__(self, key):
        super().__delitem__(key)
        self.clock.bump()

    def pop(self, key, *default):
        out = super().pop(key, *default)
        self.clock.bump()
        return out

    def clear(self):
        super().clear()
        self.clock.bump()
