"""Structured leveled logger (reference: logger/ 516 LoC Logger iface with
Debugf/Infof/Warnf/Errorf + query logger).

Own copy of featurebase_tpu/utils/logger.py.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import IO, Optional

LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}


class Logger:
    def __init__(self, level: str = "info", stream: Optional[IO] = None,
                 name: str = "featurebase_tpu_torch"):
        self.level = LEVELS.get(level, 20)
        self.stream = stream or sys.stderr
        self.name = name
        self._lock = threading.Lock()

    def _log(self, lvl: str, fmt: str, *args):
        if LEVELS[lvl] < self.level:
            return
        ts = time.strftime("%Y-%m-%dT%H:%M:%S")
        msg = fmt % args if args else fmt
        with self._lock:
            self.stream.write(f"{ts} {lvl.upper():5s} {self.name}: {msg}\n")
            self.stream.flush()

    def debug(self, fmt, *a):
        self._log("debug", fmt, *a)

    def info(self, fmt, *a):
        self._log("info", fmt, *a)

    def warn(self, fmt, *a):
        self._log("warn", fmt, *a)

    def error(self, fmt, *a):
        self._log("error", fmt, *a)


class NopLogger(Logger):
    def _log(self, *a):
        pass


DEFAULT = Logger()
