"""Per-query execution context: cooperative cancellation and a deadline
(own copy of featurebase_tpu/executor/qcontext.py).

Replaces the reference's context.Context plumbing through the executor
(reference: executor.go checks ctx.Err() between shard jobs; api.go:2089
query timeouts).  A thread-local holds the active query's cancel event and
deadline; the executor calls check_interrupt() between calls, the same
granularity as the reference's per-job checks."""
from __future__ import annotations

import threading
import time
from typing import Optional


class QueryCanceled(Exception):
    pass


class QueryTimeout(Exception):
    pass


_tls = threading.local()


class QueryContext:
    __slots__ = ("deadline", "cancel_ev")

    def __init__(self, timeout: Optional[float] = None,
                 cancel_ev: Optional[threading.Event] = None):
        self.deadline = (time.monotonic() + timeout) if timeout else None
        self.cancel_ev = cancel_ev

    def __enter__(self):
        _tls.ctx = self
        return self

    def __exit__(self, *exc):
        _tls.ctx = None


def current() -> Optional[QueryContext]:
    return getattr(_tls, "ctx", None)


def check_interrupt():
    """Raise if the active query was canceled or timed out.  Cheap; called
    between calls."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return
    if ctx.cancel_ev is not None and ctx.cancel_ev.is_set():
        raise QueryCanceled("query canceled")
    if ctx.deadline is not None and time.monotonic() > ctx.deadline:
        raise QueryTimeout("query deadline exceeded")
