"""A whole run of each cell at two shards on the CPU (the look for a card
skipped): the last line's keys, the checks last, the cell's metrics, and
`correct` true over every answer."""
import json

import pytest
import torch

from portbench import compare, run, spec, traffic

from . import helpers
from .helpers import SEED


def _run(monkeypatch, capsys, cell, trace, check_share=1.0):
    bench = helpers.benchmark()
    monkeypatch.setattr(spec, "benchmark", helpers.benchmark)
    monkeypatch.setattr(run, "require_devices",
                        lambda chips: torch.device("cpu"))
    real = spec.cell
    monkeypatch.setattr(spec, "cell",
                        lambda b, name, shards=None: real(b, name, 2))
    load = traffic.load
    monkeypatch.setattr(traffic, "load", lambda name: dict(
        load(name), check_share=check_share))
    monkeypatch.setattr(compare, "MIN_COMPARED", 1)
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "3", "--trace", str(trace)])
    cap = capsys.readouterr()
    return rc, cap.out.strip().splitlines(), cap.err.strip().splitlines(), \
        bench


@pytest.mark.parametrize("cell,trace", [("taxi-groupby-c1", 0),
                                        ("ssb-q1-c1", 0),
                                        ("ssb-q1-c1", 1)])
def test_last_line(monkeypatch, capsys, cell, trace):
    rc, out, err, bench = _run(monkeypatch, capsys, cell, trace)
    assert rc == 0
    res = json.loads(out[-1])
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in run.cell_metrics(bench, cell, bool(trace))}
    if trace:
        assert set(res["metrics"]) <= want
        assert "device_idle_pct" in res["metrics"]
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert res["device"]["count"] == 1
    checks = [line for line in err if line.startswith("check ")]
    assert err[-len(checks):] == checks
    assert {c.split()[1] for c in checks} == set(res["checks"])


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = run.main(["--workload", "ssb-q1-c1", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
