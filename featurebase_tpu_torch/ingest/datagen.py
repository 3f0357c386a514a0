"""Synthetic data generation kit (reference: idk/datagen — the datagen
CLI with named source generators, custom YAML-style sources, and kafka or
direct-index targets; idk/datagen/cmd.go, customer.go, equipment.go,
kitchen-sink.go, custom.go).

Sources yield (schema, record-batch) streams; targets land them either
directly into an index through the API's bulk-import paths or as JSON
messages on a Kafka topic (the in-process broker or any legacy/flexible
real broker via ingest/kafka_source.py).

Own copy of featurebase_tpu/ingest/datagen.py, with one difference:
generate_batches yields a decimal field's values in scaled units, as the
JAX package's does, and load_index and load_kafka hand them on as decimals
(value / 10^scale).  The JAX package hands on the scaled integer, which
import_values scales again and rejects past the field's max
(featurebase_tpu/ingest/datagen.py:150 and :171), so its kitchen-sink
source loads nowhere.
"""
from __future__ import annotations

import json
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# field spec: {"type": ..., plus type-specific options}
Schema = Dict[str, dict]

_SEGMENTS = ["consumer", "smb", "enterprise", "public", "edu"]
_REGIONS = ["north", "south", "east", "west", "central"]
_EQUIP_TYPES = ["excavator", "crane", "loader", "dozer", "grader",
                "truck", "forklift"]


def builtin_sources() -> Dict[str, Schema]:
    """Named generators (reference: datagen --source list)."""
    return {
        "customer": {
            "age": {"type": "int", "min": 18, "max": 95},
            "segment": {"type": "mutex", "values": len(_SEGMENTS)},
            "region": {"type": "mutex", "values": len(_REGIONS)},
            "spend": {"type": "int", "min": 0, "max": 100000},
            "active": {"type": "bool"},
            "interests": {"type": "set", "values": 24, "per_record": 3},
        },
        "equipment": {
            "etype": {"type": "mutex", "values": len(_EQUIP_TYPES)},
            "year": {"type": "int", "min": 1990, "max": 2026},
            "cost": {"type": "int", "min": 10000, "max": 2000000},
            "available": {"type": "bool"},
        },
        "kitchen-sink": {
            "s": {"type": "set", "values": 8, "per_record": 2},
            "m": {"type": "mutex", "values": 5},
            "b": {"type": "bool"},
            "i": {"type": "int", "min": -1000, "max": 1000},
            "d": {"type": "decimal", "min": 0, "max": 10000, "scale": 2},
            "ts": {"type": "timestamp", "min": 1_500_000_000,
                   "max": 1_700_000_000},
        },
    }


def resolve_source(source: str,
                   custom: Optional[Schema] = None) -> Schema:
    if source == "custom":
        if not custom:
            raise ValueError("custom source requires a schema config "
                             "(reference: datagen --custom-config)")
        return custom
    schemas = builtin_sources()
    if source not in schemas:
        raise ValueError(
            f"unknown source {source!r}; available: "
            f"{', '.join(sorted(schemas))} or custom")
    return schemas[source]


def generate_batches(schema: Schema, start_from: int, end_at: int,
                     seed: int = 0, batch_size: int = 10_000
                     ) -> Iterator[Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """Yields (ids, {field: values}) batches; deterministic in (seed,
    id-range) so re-runs and sharded runs reproduce the same records
    (reference: datagen --seed / --start-from / --end-at)."""
    rng = np.random.default_rng(seed)
    lo = start_from
    while lo <= end_at:
        hi = min(lo + batch_size - 1, end_at)
        ids = np.arange(lo, hi + 1, dtype=np.int64)
        n = ids.size
        cols: Dict[str, np.ndarray] = {}
        for fname, spec in schema.items():
            t = spec.get("type", "int")
            if t in ("int", "timestamp"):
                cols[fname] = rng.integers(spec.get("min", 0),
                                           spec.get("max", 1000) + 1,
                                           size=n)
            elif t == "decimal":
                scale = 10 ** spec.get("scale", 2)
                cols[fname] = rng.integers(
                    spec.get("min", 0) * scale,
                    spec.get("max", 100) * scale + 1, size=n)
            elif t in ("mutex", "id"):
                cols[fname] = rng.integers(0, spec.get("values", 8),
                                           size=n)
            elif t == "bool":
                cols[fname] = rng.integers(0, 2, size=n)
            elif t == "set":
                k = spec.get("per_record", 2)
                cols[fname] = rng.integers(0, spec.get("values", 8),
                                           size=(n, k))
            else:
                raise ValueError(f"unknown field type {t!r} for {fname}")
        yield ids, cols
        lo = hi + 1


def _as_loaded(spec: dict, vals: np.ndarray) -> np.ndarray:
    """A field's generated values as load_index and load_kafka hand them
    on: a decimal's scaled integers as decimals, others unchanged."""
    if spec.get("type", "int") == "decimal":
        return vals / (10 ** spec.get("scale", 2))
    return vals


def ensure_schema(api, index: str, schema: Schema):
    api.create_index(index, {"trackExistence": True}, if_not_exists=True)
    for fname, spec in schema.items():
        t = spec.get("type", "int")
        opts = {"type": "set" if t == "set" else
                "mutex" if t in ("mutex", "id") else t}
        if t in ("int", "timestamp", "decimal"):
            opts.update(min=spec.get("min", 0), max=spec.get("max", 1000))
        if t == "decimal":
            opts["scale"] = spec.get("scale", 2)
        if t == "timestamp":
            opts = {"type": "int", "min": spec.get("min", 0),
                    "max": spec.get("max", 2_000_000_000)}
        api.create_field(index, fname, opts, if_not_exists=True)


def load_index(api, index: str, source: str, start_from: int = 0,
               end_at: int = 999, seed: int = 0,
               batch_size: int = 10_000,
               custom: Optional[Schema] = None,
               progress=None) -> int:
    """Generate straight into an index through the bulk-import paths
    (reference: datagen --target pilosa)."""
    schema = resolve_source(source, custom)
    ensure_schema(api, index, schema)
    total = 0
    for ids, cols in generate_batches(schema, start_from, end_at, seed,
                                      batch_size):
        for fname, vals in cols.items():
            t = schema[fname].get("type", "int")
            if t == "set":
                k = vals.shape[1]
                api.import_bits(index, fname,
                                vals.reshape(-1).tolist(),
                                np.repeat(ids, k).tolist())
            elif t in ("mutex", "id", "bool"):
                api.import_bits(index, fname, vals.tolist(), ids.tolist())
            else:
                api.import_values(index, fname, ids.tolist(),
                                  _as_loaded(schema[fname], vals).tolist())
        total += ids.size
        if progress:
            progress(total)
    return total


def load_kafka(client, topic: str, source: str, start_from: int = 0,
               end_at: int = 999, seed: int = 0, partition: int = 0,
               batch_size: int = 1000,
               custom: Optional[Schema] = None) -> int:
    """Generate JSON records onto a Kafka topic (reference: datagen
    --target kafka; kafka.batch-size)."""
    schema = resolve_source(source, custom)
    total = 0
    for ids, cols in generate_batches(schema, start_from, end_at, seed,
                                      batch_size):
        msgs = []
        decimal = {f for f in cols if schema[f].get("type") == "decimal"}
        loaded = {f: _as_loaded(schema[f], v).tolist() if f in decimal
                  else v for f, v in cols.items()}
        for i, rid in enumerate(ids):
            rec = {"id": int(rid)}
            for fname, vals in loaded.items():
                if fname in decimal:
                    rec[fname] = vals[i]
                    continue
                v = vals[i]
                rec[fname] = [int(x) for x in v] if v.ndim else int(v)
            msgs.append((str(int(rid)).encode(),
                         json.dumps(rec).encode()))
        client.produce(topic, partition, msgs)
        total += len(msgs)
    return total


def load_kafka_file(client, topic: str, path: str, partition: int = 0,
                    key_column: Optional[str] = None,
                    batch_size: int = 1000) -> int:
    """Ship a CSV or JSON-lines file onto a Kafka topic as JSON messages
    (reference: idk's kafkaput + csv-kafka variants, idk/cmd/kafkaput).
    CSV headers become JSON keys; `key_column` selects the message key."""
    import csv as _csv
    total = 0
    msgs: List[tuple] = []

    def flush():
        nonlocal total
        if msgs:
            client.produce(topic, partition, list(msgs))
            total += len(msgs)
            msgs.clear()

    with open(path, newline="") as fh:
        head = fh.read(2048)
        fh.seek(0)
        is_json = head.lstrip()[:1] == "{"
        if is_json:
            rows = (json.loads(line) for line in fh if line.strip())
        else:
            rows = _csv.DictReader(fh)
        for rec in rows:
            key = str(rec[key_column]).encode() \
                if key_column and key_column in rec else None
            msgs.append((key, json.dumps(rec).encode()))
            if len(msgs) >= batch_size:
                flush()
    flush()
    return total
