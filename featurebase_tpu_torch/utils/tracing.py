"""Tracing and per-query profiling.

Mirrors the reference's pluggable tracer + profile trees (reference:
tracing/tracing.go:12 Tracer global, :22 StartProfiledSpanFromContext;
executor spans executor.go:184,6450; Options(profile=true) returns a
tracing.Profile tree in the response, executor.go:227-236).

The global TRACER collects spans per thread; profiled executions build a
nested duration tree that the executor attaches to the query response.

Own copy of featurebase_tpu/utils/tracing.py.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


class Span:
    __slots__ = ("name", "start", "duration", "tags", "children", "_parent")

    def __init__(self, name: str, parent: Optional["Span"] = None):
        self.name = name
        self.start = time.perf_counter()
        self.duration = 0.0
        self.tags: Dict[str, Any] = {}
        self.children: List["Span"] = []
        self._parent = parent

    def set_tag(self, k: str, v):
        self.tags[k] = v

    def finish(self):
        self.duration = time.perf_counter() - self.start

    def to_json(self) -> dict:
        out = {"name": self.name,
               "duration_us": int(self.duration * 1e6)}
        if self.tags:
            out["tags"] = dict(self.tags)
        if self.children:
            out["children"] = [c.to_json() for c in self.children]
        return out


class Tracer:
    """Thread-local span stacks; spans are recorded only while a profiled
    root span is active on the thread (keeps the non-profiled hot path to a
    couple of attribute checks, like the reference's NopTracer)."""

    def __init__(self):
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def start_span(self, name: str, **tags) -> "SpanCtx":
        stack = self._stack()
        parent = stack[-1] if stack else None
        if parent is None:
            return SpanCtx(self, None)  # not profiling: no-op span
        span = Span(name, parent)
        span.tags.update(tags)
        parent.children.append(span)
        stack.append(span)
        return SpanCtx(self, span)

    def start_profile(self, name: str, **tags) -> "ProfileCtx":
        """Root profiled span (reference: StartProfiledSpanFromContext)."""
        span = Span(name)
        span.tags.update(tags)
        self._stack().append(span)
        return ProfileCtx(self, span)


class SpanCtx:
    def __init__(self, tracer: Tracer, span: Optional[Span]):
        self.tracer = tracer
        self.span = span

    def set_tag(self, k, v):
        if self.span is not None:
            self.span.set_tag(k, v)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            self.span.finish()
            stack = self.tracer._stack()
            if stack and stack[-1] is self.span:
                stack.pop()


class ProfileCtx(SpanCtx):
    def profile(self) -> dict:
        return self.span.to_json()


TRACER = Tracer()
