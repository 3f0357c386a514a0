"""Query-result JSON serialization (reference: handler.go QueryResponse
marshaling + pb TableResponse shapes, simplified to JSON).

Own copy of featurebase_tpu/server/serialize.py over the port's result
types (executor/results.py, model/row.py)."""
from __future__ import annotations

from typing import Any

import numpy as np

from featurebase_tpu_torch.executor.results import (ExtractedTable, GroupCount,
                                              PairField, PairsField, ValCount)
from featurebase_tpu_torch.model.row import Row, SignedRow


def result_to_json(r: Any):
    if isinstance(r, (Row, SignedRow, ValCount, PairsField, PairField,
                      ExtractedTable)):
        return r.to_json()
    if isinstance(r, list):
        if r and isinstance(r[0], GroupCount):
            return [g.to_json() for g in r]
        return [result_to_json(x) for x in r]
    if isinstance(r, dict):
        return {k: result_to_json(v) for k, v in r.items()}
    if isinstance(r, (np.integer,)):
        return int(r)
    if isinstance(r, (np.floating,)):
        return float(r)
    if isinstance(r, np.ndarray):
        return [result_to_json(x) for x in r]
    return r


def response_to_json(results: list) -> dict:
    return {"results": [result_to_json(r) for r in results]}
