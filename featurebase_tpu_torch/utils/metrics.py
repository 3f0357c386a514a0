"""Minimal metrics registry (reference: metrics.go Prometheus counters +
/metrics.json aggregation http_handler.go:497).

Own copy of featurebase_tpu/utils/metrics.py.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        self.histograms: Dict[str, list] = defaultdict(list)
        self.start_time = time.time()

    def count(self, name: str, n: int = 1, **labels):
        key = _key(name, labels)
        with self._lock:
            self.counters[key] += n

    def gauge(self, name: str, v: float, **labels):
        with self._lock:
            self.gauges[_key(name, labels)] = v

    def observe(self, name: str, v: float, **labels):
        key = _key(name, labels)
        with self._lock:
            h = self.histograms[key]
            h.append(v)
            if len(h) > 10000:
                del h[: len(h) // 2]

    def timer(self, name: str, **labels):
        return _Timer(self, name, labels)

    def to_json(self) -> dict:
        with self._lock:
            hist = {}
            for k, v in self.histograms.items():
                if not v:
                    continue
                s = sorted(v)
                hist[k] = {
                    "count": len(s),
                    "p50": s[len(s) // 2],
                    "p99": s[min(len(s) - 1, int(len(s) * 0.99))],
                    "mean": sum(s) / len(s),
                }
            return {
                "uptime": time.time() - self.start_time,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": hist,
            }


class _Timer:
    def __init__(self, reg: Registry, name: str, labels: dict):
        self.reg, self.name, self.labels = reg, name, labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.reg.observe(self.name, time.perf_counter() - self.t0,
                         **self.labels)


def _key(name: str, labels: dict) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in
                                 sorted(labels.items())) + "}"


REGISTRY = Registry()
