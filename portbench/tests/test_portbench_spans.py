"""The per-layer metrics read from the port's spans
(portbench/metrics/spans.py): a traced run of ssb-q1-c1 at two shards on
the CPU reports each of them, the six host and wait times adding up to at
most the window's mean latency; an untraced run reports its end-to-end
metrics as before and records no span."""
import json

import pytest

from featurebase_tpu_torch.utils.tracing import TRACER
from portbench import loop

from .test_portbench_result import _run

SPAN_MS = ["frontend_host_ms", "executor_host_ms", "storage_host_ms",
           "launch_host_ms", "finish_host_ms", "device_wait_ms"]


@pytest.fixture
def windows(monkeypatch):
    """Each run's loop.Window, kept; the span totals reset before."""
    TRACER.reset()
    kept = []
    real = loop.run

    def run(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]
    monkeypatch.setattr(loop, "run", run)
    yield kept
    TRACER.reset()


def test_traced_run_reports_every_layer(monkeypatch, capsys, windows):
    rc, out, _, _ = _run(monkeypatch, capsys, "ssb-q1-c1", 1)
    assert rc == 0
    metrics = json.loads(out[-1])["metrics"]
    for name in SPAN_MS + ["leaf_miss_pct"]:
        assert metrics[name]["value"] >= 0, name
    assert metrics["leaf_miss_pct"]["unit"] == "%"
    (w,) = windows
    mean_ms = 1e3 * sum(r.done - r.sent for r in w.records) / len(w.records)
    total = sum(metrics[name]["value"] for name in SPAN_MS)
    assert 0 < total <= mean_ms


def test_untraced_run_reports_as_before(monkeypatch, capsys, windows):
    rc, out, _, _ = _run(monkeypatch, capsys, "ssb-q1-c1", 0)
    assert rc == 0
    assert set(json.loads(out[-1])["metrics"]) == {"qps", "p95_ms",
                                                   "setup_s"}
    assert TRACER.totals() == {}
