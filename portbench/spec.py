"""BENCHMARK.json and the files its names lead to: a cell's workload
entry, its configuration (portbench/configs/) and its traffic mix
(portbench/traffic/)."""
from __future__ import annotations

import json
import os
from typing import Optional

from portbench import datagen, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str, shards: Optional[int] = None):
    """(workload entry, configuration, mix) of cell `name`; `shards` cuts
    the configuration to that many shards, the last one partial (tests)."""
    wl = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    if shards is not None:
        cfg = dict(cfg, shards=shards,
                   records=min(cfg["records"],
                               shards * datagen.RECORDS_PER_SHARD - 4321))
    return wl, cfg, traffic.load(wl["traffic"])
