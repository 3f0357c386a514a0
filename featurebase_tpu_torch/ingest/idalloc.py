"""ID allocator with (key, session, offset) exactly-once reservation
semantics (reference: idalloc.go:19 IDAllocKey, reserveIDs/commitIDs;
API api.go:2460 ReserveIDs, 2475 CommitIDs).

Ingest clients reserve a contiguous range of record IDs under an
(index, key) with a session UUID and a monotonically increasing offset; on
replay (same session + same offset) the same range is returned, giving
exactly-once auto-id assignment across retries.

Own copy of featurebase_tpu/ingest/idalloc.py.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class IDRange:
    __slots__ = ("start", "end")  # inclusive start, exclusive end

    def __init__(self, start: int, end: int):
        self.start = start
        self.end = end

    def to_json(self):
        return {"start": self.start, "end": self.end - 1}  # reference: incl.


class _KeyState:
    def __init__(self):
        self.next_id = 1
        self.session: Optional[bytes] = None
        self.offset = 0                # next uncommitted offset
        self.last_range: Optional[IDRange] = None
        self.last_offset = -1


class IDAllocator:
    def __init__(self):
        self._lock = threading.Lock()
        self._keys: Dict[Tuple[str, str], _KeyState] = {}

    def reserve(self, index: str, key: str, session: bytes, offset: int,
                count: int) -> List[IDRange]:
        """Reserve `count` ids.  Replaying an offset returns the previously
        granted range — even from a NEW session (a restarted ingester), so
        a crash anywhere between import and offset-commit replays with the
        SAME ids instead of duplicating records (reference idalloc.go
        reserveIDs; the session-adoption strengthening covers the
        crash-before-commit window)."""
        with self._lock:
            st = self._keys.setdefault((index, key), _KeyState())
            if offset == st.last_offset and st.last_range is not None \
                    and (st.last_range.end - st.last_range.start) == count:
                st.session = session  # restarted ingester adopts the key
                return [st.last_range]
            if st.session != session:
                st.session = session
            if st.last_offset >= 0 and offset < st.last_offset:
                raise ValueError(
                    f"offset {offset} precedes committed offset "
                    f"{st.last_offset}")
            r = IDRange(st.next_id, st.next_id + count)
            st.next_id += count
            st.last_offset = offset
            st.last_range = r
            return [r]

    def commit(self, index: str, key: str, session: bytes, offset: int,
               count: int):
        with self._lock:
            st = self._keys.get((index, key))
            if st is None or st.session != session:
                raise ValueError("no reservation for session")
            st.offset = offset + 1

    def reset(self, index: str, key: str):
        with self._lock:
            self._keys.pop((index, key), None)

    def to_json(self) -> dict:
        with self._lock:
            out = {}
            for (i, k), st in self._keys.items():
                d = {"next": st.next_id, "offset": st.offset,
                     "last_offset": st.last_offset}
                if st.last_range is not None:
                    d["last_start"] = st.last_range.start
                    d["last_end"] = st.last_range.end
                out[f"{i}\x00{k}"] = d
            return out

    def restore_json(self, d: dict):
        with self._lock:
            for composite, v in d.items():
                i, k = composite.split("\x00", 1)
                st = _KeyState()
                st.next_id = v["next"]
                st.offset = v["offset"]
                st.last_offset = v.get("last_offset", -1)
                if "last_start" in v:
                    st.last_range = IDRange(v["last_start"], v["last_end"])
                self._keys[(i, k)] = st
