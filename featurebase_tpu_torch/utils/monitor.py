"""Error monitoring and usage diagnostics, kept in process (reference:
monitor/monitor.go:26 Sentry error monitor; diagnostics.go:29
diagnosticsCollector).

Own copy of featurebase_tpu/utils/monitor.py without its remote sinks:
ErrorMonitor keeps captured exceptions and messages in a bounded ring, and
DiagnosticsCollector assembles the anonymous payload the reference ships
(version, uptime, schema and shape counts, platform), reporting the torch
device where the JAX package reports its backend.  Nothing is sent
anywhere; a server that exposes them is queue 1 item 12 of ROADMAP.md.
"""
from __future__ import annotations

import platform
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List

LEVEL_PANIC, LEVEL_ERROR, LEVEL_WARN, LEVEL_INFO, LEVEL_DEBUG = range(5)
_LEVEL_NAMES = ["panic", "error", "warn", "info", "debug"]


class ErrorMonitor:
    """Bounded in-process error event ring (reference:
    monitor.CaptureException/CaptureMessage)."""

    def __init__(self, version: str = "", ring: int = 200):
        self.version = version
        self.events: deque = deque(maxlen=ring)
        self._lock = threading.Lock()

    def capture_exception(self, exc: BaseException,
                          level: int = LEVEL_ERROR, **context):
        self._record({
            "kind": "exception",
            "level": _LEVEL_NAMES[min(level, LEVEL_DEBUG)],
            "type": type(exc).__name__,
            "message": str(exc),
            "stack": traceback.format_exception(type(exc), exc,
                                                exc.__traceback__),
            "context": context,
        })

    def capture_message(self, message: str, level: int = LEVEL_INFO,
                        **context):
        self._record({"kind": "message",
                      "level": _LEVEL_NAMES[min(level, LEVEL_DEBUG)],
                      "message": message, "context": context})

    def _record(self, event: Dict[str, Any]):
        event["ts"] = time.time()
        event["release"] = self.version
        with self._lock:
            self.events.append(event)

    def recent(self, n: int = 50) -> List[dict]:
        with self._lock:
            return list(self.events)[-n:]


class DiagnosticsCollector:
    """Anonymous usage payload (reference: diagnostics.go:29)."""

    def __init__(self, api, version: str = ""):
        self.api = api
        self.version = version
        self.start = time.time()

    def payload(self) -> dict:
        h = self.api.holder
        num_fields = sum(len(i.public_fields()) for i in h.indexes.values())
        shards = sum(len(i.available_shards()) for i in h.indexes.values())
        dev = self.api.executor.device
        out = {
            "version": self.version,
            "uptime_s": int(time.time() - self.start),
            "numIndexes": len(h.indexes),
            "numFields": num_fields,
            "numShards": shards,
            "OS": platform.system(),
            "arch": platform.machine(),
            "pyVersion": platform.python_version(),
            "numNodes": 1,
            "backend": dev.type,
            "numDevices": 1,
        }
        if dev.type == "cuda":
            import torch
            out["deviceName"] = torch.cuda.get_device_name(dev)
        return out
