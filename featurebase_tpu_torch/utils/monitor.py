"""Error monitoring and usage diagnostics (reference: monitor/monitor.go:26
Sentry error monitor; diagnostics.go:29 diagnosticsCollector with its
version check-in).

Own copy of featurebase_tpu/utils/monitor.py.  Both sinks are opt-in:

- ErrorMonitor keeps captured exceptions and messages in a bounded ring
  (served at /internal/errors) and POSTs each event as JSON to `dsn` when
  one is configured (FEATUREBASE_TPU_SENTRY_DSN), fire and forget.
- DiagnosticsCollector assembles the anonymous payload the reference ships
  (version, uptime, schema and shape counts, platform; the torch backend,
  "cuda" or "cpu", and the device count where the JAX package reports its
  backend) and checks the version endpoint only when
  FEATUREBASE_TPU_DIAGNOSTICS_URL is set; otherwise it only exposes the
  payload at /internal/diagnostics.
"""
from __future__ import annotations

import json
import os
import platform
import threading
import time
import traceback
import urllib.request
from collections import deque
from typing import Any, Dict, List, Optional

LEVEL_PANIC, LEVEL_ERROR, LEVEL_WARN, LEVEL_INFO, LEVEL_DEBUG = range(5)
_LEVEL_NAMES = ["panic", "error", "warn", "info", "debug"]


class ErrorMonitor:
    """Bounded in-process error event ring and optional remote sink
    (reference: monitor.CaptureException/CaptureMessage)."""

    def __init__(self, version: str = "", dsn: Optional[str] = None,
                 ring: int = 200):
        self.version = version
        self.dsn = dsn if dsn is not None else \
            os.environ.get("FEATUREBASE_TPU_SENTRY_DSN") or None
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
        if self.dsn:
            # fire and forget: monitoring must never block or fail a query
            threading.Thread(target=self._post, args=(event,),
                             daemon=True).start()

    def _post(self, event: Dict[str, Any]):
        try:
            req = urllib.request.Request(
                self.dsn, data=json.dumps(event).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=5).read()
        except Exception:  # noqa: BLE001 — best effort by design
            pass

    def recent(self, n: int = 50) -> List[dict]:
        with self._lock:
            return list(self.events)[-n:]


class DiagnosticsCollector:
    """Anonymous usage payload and version check-in (reference:
    diagnostics.go:29; verchk.go).  Remote reporting happens only when a URL
    is configured."""

    def __init__(self, api, version: str = "", url: Optional[str] = None):
        self.api = api
        self.version = version
        self.url = url if url is not None else \
            os.environ.get("FEATUREBASE_TPU_DIAGNOSTICS_URL") or None
        self.start = time.time()
        self.last_version_check: Optional[dict] = None

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
            out["numDevices"] = torch.cuda.device_count()
            out["deviceName"] = torch.cuda.get_device_name(dev)
        return out

    def check_version(self) -> Optional[dict]:
        """POST the payload; the endpoint answers with the latest release
        (reference: versionResponse{Version, Message})."""
        if not self.url:
            return None
        try:
            req = urllib.request.Request(
                self.url, data=json.dumps(self.payload()).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                self.last_version_check = json.loads(resp.read() or b"{}")
        except Exception:  # noqa: BLE001 — diagnostics are best effort
            return None
        return self.last_version_check
