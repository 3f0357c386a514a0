"""Live process profiling endpoints (the /debug/pprof role).

The reference mounts Go pprof + fgprof on its HTTP handler
(http_handler.go:493-494) and supports signal-triggered dumps (pprof.go).
Own copy of featurebase_tpu/utils/profiling.py; CPython equivalents, no
external tooling required:

- `thread_stacks()` — every live thread's current Python stack (the
  goroutine-dump analog).
- `cpu_profile(seconds)` — a wall-clock sampling profiler over
  sys._current_frames (the py-spy/fgprof approach): samples all threads
  at ~200 Hz and returns collapsed-stack lines ("frame;frame;frame N"),
  directly consumable by flamegraph tooling.
- `heap_profile()` — tracemalloc top allocation sites (started on first
  request; subsequent calls diff against a running trace).
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import Counter
from typing import Dict, List


def thread_stacks() -> str:
    """All threads' current stacks as text (reference: pprof goroutine)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {ident} ({names.get(ident, '?')}) ---")
        out.extend(line.rstrip()
                   for line in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out)


def cpu_profile(seconds: float = 1.0, hz: int = 200) -> str:
    """Collapsed-stack wall-clock samples across ALL threads for
    `seconds` (reference: fgprof's wall-clock profile, mounted at
    http_handler.go:494).  Lines are "outermost;...;innermost count"."""
    seconds = max(0.01, min(float(seconds), 60.0))
    interval = 1.0 / hz
    me = threading.get_ident()
    samples: Counter = Counter()
    deadline = time.perf_counter() + seconds
    n = 0
    while time.perf_counter() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue  # don't profile the profiler
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} "
                             f"({code.co_filename.rsplit('/', 1)[-1]}:"
                             f"{f.f_lineno})")
                f = f.f_back
            samples[";".join(reversed(stack))] += 1
        n += 1
        time.sleep(interval)
    head = (f"# wall-clock samples: {n} ticks @ {hz} Hz over "
            f"{seconds:.2f}s, all threads\n")
    body = "\n".join(f"{stack} {count}"
                     for stack, count in samples.most_common())
    return head + body


_heap_lock = threading.Lock()
_heap_started = False


def heap_profile(top: int = 30) -> str:
    """Top allocation sites via tracemalloc (reference: pprof heap).

    Explicit windows: the first call STARTS tracing and returns
    immediately; the next call takes the snapshot AND STOPS tracing —
    tracemalloc's per-allocation overhead must never outlive the window
    (leaving it on silently slowed the whole process)."""
    import tracemalloc
    global _heap_started
    with _heap_lock:
        if not _heap_started:
            tracemalloc.start(10)
            _heap_started = True
            return ("# tracemalloc started; call again to snapshot the "
                    "allocations made from now on (tracing stops then)\n")
        snap = tracemalloc.take_snapshot()
        tracemalloc.stop()
        _heap_started = False
    stats = snap.statistics("lineno")
    total = sum(s.size for s in stats)
    out = [f"# heap: {total / 1e6:.1f} MB traced in this window, "
           f"top {top} sites (tracing stopped)"]
    for s in stats[:top]:
        out.append(f"{s.size / 1e3:.1f} KB x{s.count}  {s.traceback}")
    return "\n".join(out) + "\n"
