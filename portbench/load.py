"""Set-up of the system under test: a configuration's columns, made on the
device from the seed (portbench/datagen.py), packed there into whole rows of
32-bit words and BSI planes in the layout of the port's
core/consts.py (a shard's column c at word c >> 5, bit c & 31; a BSI group
as the exists row, the sign row, then the magnitude planes), copied to the
host a chunk of shards at a time and handed to the port's fragments a
fragment at a time (Fragment.merge_rows_delta, the path of the port's bulk
BSI import).  No record passes through a per-record host import.
"""
from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import datagen

WORD_BITS = 32
WORDS_PER_ROW = datagen.RECORDS_PER_SHARD // WORD_BITS


def _bit_weights(device) -> torch.Tensor:
    """(32,) int32: bit b of a word (bit 31 as the int32 -2^31)."""
    return torch.tensor([1 << b for b in range(31)] + [-(1 << 31)],
                        dtype=torch.int32, device=device)


def bits_to_words(mask: torch.Tensor, shards: int) -> torch.Tensor:
    """(shards * 2^20,) bool -> (shards, WORDS_PER_ROW) int32 words; the
    sum of distinct bit weights is their OR."""
    m = mask.view(shards, WORDS_PER_ROW, WORD_BITS)
    w = _bit_weights(mask.device)
    return torch.where(m, w, 0).sum(-1, dtype=torch.int32)


def pack_set(values: torch.Tensor, rows: List[int],
             shards: int) -> torch.Tensor:
    """(shards, len(rows), W) words: row i holds the records whose value is
    rows[i] (values padded past the last record with -1)."""
    out = torch.empty((shards, len(rows), WORDS_PER_ROW), dtype=torch.int32,
                      device=values.device)
    for i, r in enumerate(rows):
        out[:, i] = bits_to_words(values == r, shards)
    return out


def pack_bsi(values: torch.Tensor, valid: torch.Tensor, depth: int,
             shards: int) -> torch.Tensor:
    """(shards, depth + 2, W): exists, sign (all clear: values >= 0), then
    the magnitude planes, least significant first."""
    out = torch.zeros((shards, depth + 2, WORDS_PER_ROW), dtype=torch.int32,
                      device=values.device)
    out[:, 0] = bits_to_words(valid, shards)
    for b in range(depth):
        out[:, 2 + b] = bits_to_words(((values >> b) & 1).bool() & valid,
                                      shards)
    return out


class _Handoff:
    """Two pinned host buffers: the device packs a chunk while a worker
    thread hands the previous one to the fragments."""

    def __init__(self, shape, pinned: bool):
        self.bufs = [torch.empty(shape, dtype=torch.int32, pin_memory=pinned)
                     for _ in range(2)]
        self.pending = [None, None]
        self.turn = 0
        self.pool = ThreadPoolExecutor(1, thread_name_prefix="portbench-load")

    def submit(self, words: torch.Tensor, fn):
        """Copy `words` to a free buffer and run fn(host uint32 array) on
        the worker."""
        i = self.turn
        self.turn ^= 1
        if self.pending[i] is not None:
            self.pending[i].result()
        buf = self.bufs[i].view(-1)[:words.numel()].view(words.shape)
        buf.copy_(words)
        self.pending[i] = self.pool.submit(fn, buf.numpy().view(np.uint32))

    def close(self):
        try:
            for p in self.pending:
                if p is not None:
                    p.result()
        finally:
            self.pool.shutdown(wait=True)


def _hand_rows(view, first: int, row_ids: List[int], present: np.ndarray,
               host: np.ndarray):
    for si in range(host.shape[0]):
        idx = np.flatnonzero(present[si])
        if idx.size == 0:
            continue
        frag = view.create_fragment_if_not_exists(first + si)
        frag.merge_rows_delta([row_ids[i] for i in idx],
                              [host[si, i] for i in idx])


def build(cfg: dict, seed: int, device, stored: Optional[Dict] = None):
    """A Holder with the configuration's index, made from `seed`.  With
    `stored`, counts into it the shards that hold each row handed over:
    {(field, row id): shards} for a set field, {(field, "bsi"): shards} for
    an int field's group."""
    from featurebase_tpu_torch.core.consts import (BSI_EXISTS_ROW,
                                                   BSI_OFFSET, BSI_SIGN_ROW)
    from featurebase_tpu_torch.model.field import FieldOptions
    from featurebase_tpu_torch.model.index import Holder, IndexOptions
    device = torch.device(device)
    holder = Holder()
    index = holder.create_index(cfg["index"], IndexOptions())
    plan = []
    for spec in cfg["fields"]:
        if spec["type"] == "set":
            f = index.create_field(spec["field"], FieldOptions(type="set"))
            plan.append((spec, f.standard_view(), datagen.field_rows(spec)))
        elif spec["type"] == "int":
            f = index.create_field(spec["field"], FieldOptions(
                type="int", min=int(spec["min"]), max=int(spec["max"])))
            depth = datagen.bsi_depth(spec)
            if f.bit_depth != depth:
                raise ValueError(f"{spec['field']}: the port's depth "
                                 f"{f.bit_depth}, the layout's {depth}")
            plan.append((spec, f.bsi_view(),
                         [BSI_EXISTS_ROW, BSI_SIGN_ROW]
                         + [BSI_OFFSET + b for b in range(depth)]))
        else:
            raise ValueError(f"unknown field type {spec['type']!r}")
    ex_view = index.existence_field().standard_view()
    widest = max(len(rows) for _, _, rows in plan)
    handoff = _Handoff((datagen.CHUNK_SHARDS, widest, WORDS_PER_ROW),
                       pinned=device.type == "cuda")
    try:
        for first, n_sh, n, cols in datagen.iter_chunks(cfg, seed, device):
            pad = n_sh * datagen.RECORDS_PER_SHARD - n
            valid = torch.arange(n_sh * datagen.RECORDS_PER_SHARD,
                                 device=device) < n
            for spec, view, rows in plan + [(None, ex_view, [0])]:
                if spec is None:
                    words = bits_to_words(valid, n_sh)[:, None]
                else:
                    v = torch.nn.functional.pad(cols[spec["col"]], (0, pad),
                                                value=-1)
                    if spec["type"] == "set":
                        words = pack_set(v, rows, n_sh)
                    else:
                        words = pack_bsi(v, valid, len(rows) - 2, n_sh)
                present = words.ne(0).any(-1).cpu().numpy() \
                    if spec is None or spec["type"] == "set" \
                    else np.ones(words.shape[:2], dtype=bool)
                if stored is not None and spec is not None:
                    keys = rows if spec["type"] == "set" else ["bsi"]
                    for r, cnt in zip(keys, present.sum(0)):
                        k = (spec["field"], r)
                        stored[k] = stored.get(k, 0) + int(cnt)
                handoff.submit(words, functools.partial(
                    _hand_rows, view, first, rows, present))
            del cols
    finally:
        handoff.close()
    return holder
