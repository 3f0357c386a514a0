"""Controller-backed key translation for DAX nodes.

Own copy of featurebase_tpu/dax/translate.py.  Computers and queryers swap
their per-index/per-field translate stores for these remote-backed ones:
creates/finds go to the controller's durable store, with a local
read-through cache (reference: dax translate roles + partition primaries,
collapsed to the controller — see dax/controller.py docstring).

Besides the JAX store's methods, the store answers the two that the port's
API and executor also ask a translate store: `checksum()` (the
/internal/translate/checksums route) over the cache, and `partitions`,
which is empty: a keyed Delete drops the deleted records' keys from a local
store's partitions, and here the keys are the controller's, so they stay.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

from featurebase_tpu_torch.cluster.client import InternalClient
from featurebase_tpu_torch.storage.translate import _checksum


class RemoteTranslateStore:
    def __init__(self, controller_uri: str, table: str, field: str = "",
                 client: Optional[InternalClient] = None):
        self.uri = controller_uri.rstrip("/")
        self.table = table
        self.field = field
        self.client = client or InternalClient(timeout=10.0)
        self._lock = threading.Lock()
        self._k2i: Dict[str, int] = {}
        self._i2k: Dict[int, str] = {}
        self.partitions: dict = {}

    def _path(self, op: str) -> str:
        if self.field:
            return f"/dax/translate/{self.table}/{self.field}/{op}"
        return f"/dax/translate/{self.table}/{op}"

    def _cache(self, mapping: Dict[str, int]):
        with self._lock:
            for k, v in mapping.items():
                self._k2i[k] = int(v)
                self._i2k[int(v)] = k

    def create_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        keys = list(keys)
        out = self.client._call(self.uri, "POST", self._path("create"),
                                {"keys": keys})
        out = {k: int(v) for k, v in out.items()}
        self._cache(out)
        return out

    def find_keys(self, keys: Iterable[str]) -> Dict[str, int]:
        keys = list(keys)
        with self._lock:
            cached = {k: self._k2i[k] for k in keys if k in self._k2i}
        missing = [k for k in keys if k not in cached]
        if missing:
            out = self.client._call(self.uri, "POST", self._path("find"),
                                    {"keys": missing})
            out = {k: int(v) for k, v in out.items()}
            self._cache(out)
            cached.update(out)
        return cached

    def translate_ids(self, ids: Iterable[int]) -> List[Optional[str]]:
        ids = [int(i) for i in ids]
        with self._lock:
            cached = {i: self._i2k[i] for i in ids if i in self._i2k}
        missing = [i for i in ids if i not in cached]
        if missing:
            out = self.client._call(self.uri, "POST", self._path("ids"),
                                    {"ids": missing})
            for i, k in zip(missing, out.get("keys", [])):
                if k is not None:
                    self._cache({k: i})
                    cached[i] = k
        return [cached.get(i) for i in ids]

    def apply_entries(self, entries: Dict[str, int]):
        self._cache({k: int(v) for k, v in entries.items()})

    def checksum(self) -> list:
        """[cached entries, their content checksum]."""
        with self._lock:
            return [len(self._k2i), _checksum(self._k2i)]

    def to_json(self):
        with self._lock:
            return {"remote": self.uri, "cached": len(self._k2i)}


def install_remote_translation(api, controller_uri: str,
                               client: Optional[InternalClient] = None):
    """Point every index/field translate store of this node's holder at the
    controller."""
    for name in list(api.holder.indexes):
        idx = api.holder.index(name)
        if not isinstance(idx.translate_store, RemoteTranslateStore):
            idx.translate_store = RemoteTranslateStore(controller_uri, name,
                                                       client=client)
        for fname, f in idx.fields.items():
            if f.options.keys:
                store = idx.field_translate_stores.get(fname)
                if not isinstance(store, RemoteTranslateStore):
                    idx.field_translate_stores[fname] = RemoteTranslateStore(
                        controller_uri, name, fname, client=client)
