"""View: named bitmap namespace within a field, holding one fragment per shard.

Own copy of featurebase_tpu/model/view.py (reference view.go:36).  View
names: "standard", "bsig_<field>" for BSI data, and time-quantum views
"standard_YYYY[MM[DD[HH]]]" (reference view.go:25-33).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from featurebase_tpu_torch.model.clock import Clock, ClockedDict
from featurebase_tpu_torch.model.fragment import Fragment

VIEW_STANDARD = "standard"


def view_bsi_group(field_name: str) -> str:
    return f"bsig_{field_name}"


class View:
    def __init__(self, index: str, field: str, name: str):
        self.index = index
        self.field = field
        self.name = name
        self._lock = threading.RLock()
        self.clock = Clock()
        self.fragments: Dict[int, Fragment] = ClockedDict(self.clock)

    def fragment(self, shard: int) -> Optional[Fragment]:
        return self.fragments.get(shard)

    def create_fragment_if_not_exists(self, shard: int) -> Fragment:
        with self._lock:
            f = self.fragments.get(shard)
            if f is None:
                f = Fragment(self.index, self.field, self.name, shard)
                self.fragments[shard] = f
            return f

    def available_shards(self) -> List[int]:
        return sorted(self.fragments)
