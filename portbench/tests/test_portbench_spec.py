"""BENCHMARK.json names only what portbench holds: every configuration,
mix and metric reader is a file found by its name."""
import os
import re

from portbench import spec

from . import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_leads_to_its_file():
    b = spec.benchmark()
    _every_name_leads_to_its_file(b)
    _every_name_leads_to_its_file(helpers.benchmark())


def _every_name_leads_to_its_file(b):
    assert b["command"][:3] == ["python3", "-m", "portbench.run"]
    assert b["paths"] == ["portbench"]
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert c["file"].startswith("portbench/configs/")
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        spec.cell(b, w["name"])
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"])
        assert os.path.exists(os.path.join(spec.ROOT, "portbench",
                                           "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= cells
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
