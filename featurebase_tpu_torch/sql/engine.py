"""SQL engine entry point (reference: sql3/ parser+planner; server/sql.go
execSQL).  Records each statement in the in-memory execution-requests table
(reference: systemlayer/systemlayer.go:8 ExecutionRequests).

Own copy of featurebase_tpu/sql/engine.py.  A statement runs where its API
runs: on CUDA unless the API was given device="cpu"."""
from __future__ import annotations

import threading
import time
import uuid
from collections import deque

from featurebase_tpu_torch.server.api import API, APIError


class ExecRequests:
    """Ring buffer of recent SQL requests (reference: systemlayer.go:8)."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity)

    def record(self, sql: str, status: str, elapsed_ms: float):
        with self._lock:
            self._ring.append([str(uuid.uuid4()), sql, status,
                               int(elapsed_ms)])

    def rows(self):
        with self._lock:
            return [list(r) for r in self._ring]


def execute_sql(api: API, sql: str) -> dict:
    from featurebase_tpu_torch.sql.planner import plan_and_execute
    if getattr(api, "exec_requests", None) is None:
        api.exec_requests = ExecRequests()
    t0 = time.monotonic()
    try:
        out = plan_and_execute(api, sql)
        api.exec_requests.record(sql, "complete",
                                 (time.monotonic() - t0) * 1e3)
        return out
    except APIError:
        api.exec_requests.record(sql, "error",
                                 (time.monotonic() - t0) * 1e3)
        raise
    except NotImplementedError as e:
        api.exec_requests.record(sql, "error",
                                 (time.monotonic() - t0) * 1e3)
        raise APIError(f"SQL not supported yet: {e}", 400)
