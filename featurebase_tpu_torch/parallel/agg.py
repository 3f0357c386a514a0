"""Host-side finishes of the stacked aggregates.

Own copy of the host part of featurebase_tpu/parallel/agg.py.  The mesh
programs there (shard_map + psum) are not ported yet; on one device the
per-plane popcounts come from kernel C (ops/cuda_kernels.py
``bsi_sum_planes``).
"""
from __future__ import annotations

import numpy as np


def finalize_sum(pos_pops, neg_pops) -> int:
    """Exact sum of 2^i (pos_i - neg_i) over per-plane popcounts, in
    Python ints (reference agg.py:179)."""
    pp = np.asarray(pos_pops).astype(np.int64)
    nn = np.asarray(neg_pops).astype(np.int64)
    return sum((1 << i) * (int(pp[i]) - int(nn[i])) for i in range(pp.size))
