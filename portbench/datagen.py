"""Per-record columns of a configuration, made from the seed a chunk of
shards at a time on the device.

A chunk is CHUNK_SHARDS shards of RECORDS_PER_SHARD records (the last
chunk, and the last shard, may hold fewer).  Each chunk draws its columns
from a torch.Generator of its own, seeded from (seed, chunk), so set-up and
the reference after the window make the same columns chunk by chunk without
keeping them.  A configuration lists its columns in order; each names a
generator kind (``gen``) from portbench/gens/ and may read the columns made
before it.
"""
from __future__ import annotations

import hashlib
import importlib
from typing import Dict, Iterator, List, Tuple

import torch

# Columns a shard (2^20, the layout's shard width) and shards a chunk.
RECORDS_PER_SHARD = 1 << 20
CHUNK_SHARDS = 32


def chunk_seed(seed: int, chunk: int) -> int:
    """A 63-bit generator seed for one chunk of one run's seed."""
    h = hashlib.blake2b(f"{int(seed)}:{int(chunk)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def chunks(cfg: dict) -> List[Tuple[int, int, int]]:
    """(first shard, shards, records) of each chunk."""
    total, shards = int(cfg["records"]), int(cfg["shards"])
    if not (shards - 1) * RECORDS_PER_SHARD < total \
            <= shards * RECORDS_PER_SHARD:
        raise ValueError(f"{cfg['name']}: {total} records do not fill "
                         f"{shards} shards")
    out = []
    for first in range(0, shards, CHUNK_SHARDS):
        n_sh = min(CHUNK_SHARDS, shards - first)
        n = min(total - first * RECORDS_PER_SHARD, n_sh * RECORDS_PER_SHARD)
        out.append((first, n_sh, n))
    return out


def _kind(name: str):
    return importlib.import_module(f"portbench.gens.{name}")


def columns(cfg: dict, seed: int, chunk: int, n: int,
            device) -> Dict[str, torch.Tensor]:
    """Every column of one chunk of `n` records, (n,) int64 on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, chunk))
    cols: Dict[str, torch.Tensor] = {}
    for spec in cfg["columns"]:
        cols[spec["col"]] = _kind(spec["gen"]).generate(spec, n, gen, cols,
                                                        device)
    return cols


def iter_chunks(cfg: dict, seed: int, device
                ) -> Iterator[Tuple[int, int, int, Dict[str, torch.Tensor]]]:
    """(first shard, shards, records, columns) of each chunk in order."""
    for c, (first, n_sh, n) in enumerate(chunks(cfg)):
        yield first, n_sh, n, columns(cfg, seed, c, n, device)


def field_rows(spec: dict) -> List[int]:
    """The row ids of a set field's spec: a list, or {"from", "to"}."""
    rows = spec["rows"]
    if isinstance(rows, dict):
        return list(range(int(rows["from"]), int(rows["to"]) + 1))
    return [int(r) for r in rows]


def bsi_depth(spec: dict) -> int:
    """Magnitude planes of an int field whose values lie in [min, max]
    with min >= 0 (base 0)."""
    if int(spec["min"]) < 0:
        raise ValueError(f"{spec['field']}: negative values are not made")
    return max(1, int(spec["max"]).bit_length())
