"""A run with the timed path broken underneath comes out not correct:
an answer altered where the port produces it, and half of the shards
left out of every query."""
import json

import pytest
import torch

from portbench import compare, run, spec, traffic

from . import helpers
from .helpers import SEED


def _run(monkeypatch, capsys, cell):
    monkeypatch.setattr(spec, "benchmark", helpers.benchmark)
    monkeypatch.setattr(run, "require_devices",
                        lambda chips: torch.device("cpu"))
    real = spec.cell
    monkeypatch.setattr(spec, "cell",
                        lambda b, name, shards=None: real(b, name, 2))
    load = traffic.load
    monkeypatch.setattr(traffic, "load",
                        lambda name: dict(load(name), check_share=1.0))
    monkeypatch.setattr(compare, "MIN_COMPARED", 1)
    assert run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                     "3", "--trace", "0"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _alter_answers(monkeypatch):
    from featurebase_tpu_torch.executor import executor as ex
    from featurebase_tpu_torch.ops import bsi as bsiops
    add_counts = ex.Executor._add_counts
    finish_groups = bsiops.finish_groups
    finalize_sum = ex.finalize_sum

    def counts_off(groups, keys, counts):
        counts = counts.copy()
        counts.flat[0] += 1
        add_counts(groups, keys, counts)

    monkeypatch.setattr(ex.Executor, "_add_counts",
                        staticmethod(counts_off))
    monkeypatch.setattr(bsiops, "finish_groups", lambda parts: [
        (s + (i == 0), c) for i, (s, c) in enumerate(finish_groups(parts))])
    monkeypatch.setattr(ex, "finalize_sum",
                        lambda *a: finalize_sum(*a) + 1)


def _half_the_shards(monkeypatch):
    from featurebase_tpu_torch.executor import executor as ex
    shards = ex.Executor._shards

    def half(self, index, s):
        out = shards(self, index, s)
        return out[:max(1, len(out) // 2)]
    monkeypatch.setattr(ex.Executor, "_shards", half)


@pytest.mark.parametrize("cell", ["taxi-groupby-c1", "ssb-q1-c1"])
@pytest.mark.parametrize("fault", [_alter_answers, _half_the_shards])
def test_fault_is_not_correct(monkeypatch, capsys, cell, fault):
    fault(monkeypatch)
    res = _run(monkeypatch, capsys, cell)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0
    assert res["checks"]["answers_compared"]["value"] >= 1
