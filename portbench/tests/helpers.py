"""Shared set-up of the benchmark's tests: small cuts of the cells, run
on the CPU."""
import numpy as np
import torch

from portbench import datagen, spec

CPU = torch.device("cpu")
SEED = 2**31 + 12345


# The taxi configuration and mix are kept for a later cell (PERF.md, Open
# questions); the tests run them as this cell.
TAXI_CONFIG = {"name": "taxi-1b",
               "source": "https://tech.marksblogg.com/benchmarks.html",
               "file": "portbench/configs/taxi-1b.json", "reduced": [],
               "why": "1.1 B taxi rides"}
TAXI_CELL = {"name": "taxi-groupby-c1", "config": "taxi-1b",
             "traffic": "taxi-groupby", "chips": 1, "why": "Q2-Q4"}


_benchmark = spec.benchmark


def benchmark() -> dict:
    """BENCHMARK.json with the taxi cell added."""
    b = _benchmark()
    b["configs"].append(TAXI_CONFIG)
    b["workloads"].append(TAXI_CELL)
    return b


def small(cell: str, shards: int = 2):
    """(workload, cfg, mix) of `cell` cut to `shards` shards."""
    return spec.cell(benchmark(), cell, shards)


def imported_holder(cfg: dict, seed: int):
    """A Holder with the same records as load.build, loaded column by
    column through the port's host imports (Field.import_bits,
    Field.import_values) and the existence row."""
    from featurebase_tpu_torch.model.field import FieldOptions
    from featurebase_tpu_torch.model.index import Holder, IndexOptions
    holder = Holder()
    index = holder.create_index(cfg["index"], IndexOptions())
    fields = {}
    for f in cfg["fields"]:
        if f["type"] == "set":
            fields[f["field"]] = index.create_field(
                f["field"], FieldOptions(type="set"))
        else:
            fields[f["field"]] = index.create_field(
                f["field"], FieldOptions(type="int", min=f["min"],
                                         max=f["max"]))
    for first, _, n, cols in datagen.iter_chunks(cfg, seed, CPU):
        ids = np.arange(first * datagen.RECORDS_PER_SHARD,
                        first * datagen.RECORDS_PER_SHARD + n)
        for f in cfg["fields"]:
            v = cols[f["col"]].numpy()
            if f["type"] == "set":
                fields[f["field"]].import_bits(v, ids)
            else:
                fields[f["field"]].import_values(ids, v)
        index.mark_exists(ids)
    return holder
