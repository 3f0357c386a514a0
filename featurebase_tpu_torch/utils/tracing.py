"""Tracing and per-query profiling.

Mirrors the reference's pluggable tracer + profile trees (reference:
tracing/tracing.go:12 Tracer global, :22 StartProfiledSpanFromContext;
executor spans executor.go:184,6450; Options(profile=true) returns a
tracing.Profile tree in the response, executor.go:227-236).

A span is a timed region of one layer of the query path.  Spans are kept in
two cases:

- a query profiled with Options(profile=true): the root span ``query`` and
  the executor's call spans (``start_span``) form a nested duration tree
  that the API attaches to the response (``Span.to_json``);
- a torch.profiler session recording (torch.autograd.profiler's flag, the
  same on every thread): every span opens a profiler range of its name on
  its own thread, which puts it on the device trace's clock, and adds its
  count, wall and self nanoseconds to per-name totals
  (``totals()``, ``reset()``).  Self time is the span's duration less the
  spans opened under it on its thread.  A counter (``count``) adds to the
  count of its name there alone, with no time and no range.

Otherwise ``span`` and ``start_span`` return one shared no-op after one
check and allocate nothing, and ``count`` returns after the same check.
The root span ``query`` is always timed: its duration is the query's one
measurement (the API's query_seconds and the tracker's runtime).

A span's parent is the innermost span open where it starts, kept in a
context variable, so a job of the worker pool (utils/pool.py runs each in a
copy of the submitting thread's context) carries its query's parent and id.
Span names never start with "cu" or "q|" and are never "portbench:window":
the benchmark's trace reader takes those for runtime calls and its labels.

Own copy of featurebase_tpu/utils/tracing.py, extended.
"""
from __future__ import annotations

import contextvars
import threading
import time
from typing import Any, Dict, List, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

# the innermost open span of this context
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "featurebase_tpu_torch.span", default=None)


class _Off:
    """The span when nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


OFF = _Off()


class Span:
    """A span that is kept: in a profile tree, under the profiler, or the
    always-timed root of a query.  `_parent` is the innermost span open
    where it started; `qid` the tracker id of its query; `tree` the node of
    a profile tree that executor spans under it hang from (itself for a
    node of the tree)."""

    __slots__ = ("name", "ns", "tags", "children", "_parent", "qid", "tree",
                 "_tracer", "_t0", "_child_ns", "_thread", "_range",
                 "_token", "_profiled")

    def __init__(self, tracer: "Tracer", name: str, parent: Optional["Span"],
                 record: bool):
        self.name = name
        self.ns = 0
        self.tags: Dict[str, Any] = {}
        self.children: List["Span"] = []
        self._parent = parent
        self.qid = parent.qid if parent is not None else None
        self.tree = parent.tree if parent is not None else None
        self._tracer = tracer
        self._child_ns = 0
        self._profiled = False
        self._thread = threading.get_ident() if record else None
        self._range = None
        if record:
            self._range = _RecordFunctionFast(name)
            self._range.__enter__()
        self._token = _CURRENT.set(self)
        self._t0 = time.perf_counter_ns()

    @property
    def duration(self) -> float:
        """Seconds from start to finish."""
        return self.ns / 1e9

    def profile(self) -> None:
        """Make this span the root of a profile tree (Options(profile=
        true)): the executor's spans under it become its tree."""
        if not self._profiled:
            self._profiled = True
            self.tree = self
            self._tracer._open_tree(1)

    def finish(self) -> None:
        self.ns = time.perf_counter_ns() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        _CURRENT.reset(self._token)
        if self._profiled:
            self._tracer._open_tree(-1)
        parent = self._parent
        if self._thread is not None:
            if parent is not None and parent._thread == self._thread:
                parent._child_ns += self.ns
            self._tracer._record(self)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.finish()

    def to_json(self) -> dict:
        out = {"name": self.name,
               "duration_us": int(self.duration * 1e6)}
        if self.tags:
            out["tags"] = dict(self.tags)
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        return out


class Tracer:
    """Spans of the query path (module docstring); per-name totals of the
    spans recorded under the profiler, over every profiler session of the
    process until reset()."""

    def __init__(self):
        self._lock = threading.Lock()
        self._trees = 0       # profile trees open in the process
        self._totals: Dict[str, list] = {}

    def span(self, name: str):
        """A layer's span: recorded only under the profiler."""
        if not _profiler._is_profiler_enabled:
            return OFF
        return Span(self, name, _CURRENT.get(), True)

    def count(self, name: str) -> None:
        """Add one to the count of `name` in totals(), with no wall or
        self time: recorded only under the profiler."""
        if _profiler._is_profiler_enabled:
            self._add(name, 0, 0)

    def start_span(self, name: str, suffix: str = ""):
        """An executor call's span `name + suffix`: a node of the profile
        tree it opens in, and recorded under the profiler."""
        record = _profiler._is_profiler_enabled
        if not (record or self._trees):
            return OFF
        parent = _CURRENT.get()
        tree = parent.tree if parent is not None else None
        if tree is None and not record:
            return OFF
        span = Span(self, name + suffix, parent, record)
        if tree is not None:
            tree.children.append(span)
            span.tree = span
        return span

    def start_query(self, qid: Optional[int], **tags) -> Span:
        """The root span ``query`` of query `qid` (the tracker's id), always
        timed; `tags` are its profile tree's."""
        span = Span(self, "query", _CURRENT.get(),
                    _profiler._is_profiler_enabled)
        span.qid = qid
        span.tags.update(tags)
        return span

    def _open_tree(self, n: int) -> None:
        with self._lock:
            self._trees += n

    def _record(self, span: Span) -> None:
        self._add(span.name, span.ns, span.ns - span._child_ns)

    def _add(self, name: str, wall_ns: int, self_ns: int) -> None:
        with self._lock:
            t = self._totals.get(name)
            if t is None:
                t = self._totals[name] = [0, 0, 0]
            t[0] += 1
            t[1] += wall_ns
            t[2] += self_ns

    def totals(self) -> Dict[str, dict]:
        """{name: {"count", "wall_ns", "self_ns"}} of the spans and
        counters recorded under the profiler since the last reset()."""
        with self._lock:
            return {name: {"count": c, "wall_ns": w, "self_ns": s}
                    for name, (c, w, s) in self._totals.items()}

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()


TRACER = Tracer()
