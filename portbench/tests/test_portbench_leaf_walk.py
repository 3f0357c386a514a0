"""leaf_walk_pct (portbench/metrics/leaf_walk_pct.py): nothing from a
program without the counter storage.leaf_walk, the count of walks over the
count of storage.leaf checks on synthetic totals, and 0 in a traced run of
ssb-q1-c1 at two shards on the CPU, whose window reads only warm leaves."""
import json

import pytest

from featurebase_tpu_torch.utils import tracing
from featurebase_tpu_torch.utils.tracing import TRACER
from portbench import run

from .test_portbench_result import _run


class Totals:
    """A TRACER that holds the given totals, with or without count()."""

    def __init__(self, totals, counter=True):
        self._totals = totals
        if counter:
            self.count = lambda name: None

    def totals(self):
        return self._totals


def leaf(n):
    return {"count": n, "wall_ns": 10 * n, "self_ns": 10 * n}


def walk(n):
    return {"count": n, "wall_ns": 0, "self_ns": 0}


@pytest.mark.parametrize("totals,counter,want", [
    ({"storage.leaf": leaf(8)}, False, None),
    ({"storage.leaf": leaf(8), "storage.leaf_walk": walk(8)}, False, None),
    ({}, True, None),
    ({"storage.leaf": leaf(8)}, True, 0.0),
    ({"storage.leaf": leaf(8), "storage.leaf_walk": walk(2)}, True, 25.0),
    ({"storage.leaf": leaf(8), "storage.leaf_walk": walk(8)}, True, 100.0),
])
def test_leaf_walk_pct_reads(monkeypatch, totals, counter, want):
    monkeypatch.setattr(tracing, "TRACER", Totals(totals, counter))
    assert run.reader("leaf_walk_pct").read(None) == want


def test_traced_run_reads_no_walk(monkeypatch, capsys):
    TRACER.reset()
    try:
        rc, out, _, _ = _run(monkeypatch, capsys, "ssb-q1-c1", 1)
    finally:
        TRACER.reset()
    assert rc == 0
    metrics = json.loads(out[-1])["metrics"]
    assert metrics["leaf_walk_pct"] == {"value": 0.0, "unit": "%"}
    assert metrics["leaf_miss_pct"]["value"] == 0.0
