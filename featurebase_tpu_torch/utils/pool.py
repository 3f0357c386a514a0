"""Intra-node worker pool for per-shard host jobs.

Own copy of featurebase_tpu/utils/pool.py (reference: task/pool.go:22,
executor.go:6714-6760 job channel / doOneJob).  Plannable calls batch every
shard into one kernel launch (executor/plan.py).  The executor hands this
pool one per-shard fallback: the host Sort past depth 31, whose decode and
sort a shard are numpy that releases the GIL.  Elsewhere the fallbacks run
on the submitting thread: on an H100, threads issuing the interpreter's
small torch ops and launches only contended, and threads running Extract's
short words-to-columns jobs were slower than one thread (PERF.md §6).

Results are returned in submission order, so associative-but-ordered
merges (ValCount.smaller, Pairs.Add) stay deterministic.  Each job runs in
its own copy of the submitting thread's contextvars (snapshot pins hold
across the pool, and a job's spans keep their query's id and parent,
utils/tracing.py) and, when CUDA is initialised, on the submitting thread's
current device and on each card's current stream there (torch keeps both
per thread, and the kernels' per-stream counters assume one stream a
query).
"""
from __future__ import annotations

import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence, TypeVar

import torch

T = TypeVar("T")
R = TypeVar("R")

_POOL: ThreadPoolExecutor | None = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(
            max_workers=max(2, os.cpu_count() or 4),
            thread_name_prefix="shard-worker")
    return _POOL


def _cuda_state():
    """(current device index, [current stream of each card]) of this
    thread, or None before CUDA is initialised."""
    if not torch.cuda.is_initialized():
        return None
    return (torch.cuda.current_device(),
            [torch.cuda.current_stream(d)
             for d in range(torch.cuda.device_count())])


def _run_on(state, fn, item):
    if state is None:
        return fn(item)
    device, streams = state
    with contextlib.ExitStack() as stack:
        for s in streams:
            stack.enter_context(torch.cuda.stream(s))
        stack.enter_context(torch.cuda.device(device))
        return fn(item)


def map_shards(fn: Callable[[T], R], items: Sequence[T]) -> List[R]:
    """Apply fn to every item, in parallel when there is more than one.
    Exceptions propagate (first one raised, like the reference's errgroup
    behavior in mapperLocal).  The submitting thread's context propagates
    to workers (per-item copy) so snapshot pins (model/snapshot.py) hold
    across the pool — a Context can't be entered concurrently, hence one
    copy per item."""
    if len(items) <= 1:
        return [fn(it) for it in items]
    import contextvars
    state = _cuda_state()
    ctxs = [contextvars.copy_context() for _ in items]
    return list(_pool().map(
        lambda pair: pair[0].run(_run_on, state, fn, pair[1]),
        zip(ctxs, items)))
