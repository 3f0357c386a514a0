"""Inter-node HTTP client (reference: internal_client.go:35 InternalClient).

Own copy of featurebase_tpu/cluster/client.py, on the same routes and
bodies.  Data-plane RPC between cluster nodes: remote query execution with
explicit shard lists (reference: internal_client.go:602 QueryNode), import
forwarding to replicas (:860,888,905), key-translation routing, schema
sync, shard snapshots and health.

All calls are blocking JSON-over-HTTP on the stdlib; retries are the
caller's job (the distributed executor retries on replicas, mirroring
reference executor.go:6503 failover).
"""
from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional


class NodeUnreachable(Exception):
    """Connection-level failure — triggers replica failover."""


class RemoteError(Exception):
    """The remote node answered with an application error."""

    def __init__(self, msg: str, status: int = 500):
        super().__init__(msg)
        self.status = status


class InternalClient:
    def __init__(self, timeout: float = 30.0,
                 auth_token: Optional[str] = None):
        self.timeout = timeout
        self.auth_token = auth_token

    # -- transport -----------------------------------------------------------

    def _call(self, uri: str, method: str, path: str,
              body: Optional[dict] = None,
              raw_body: Optional[bytes] = None,
              headers: Optional[Dict[str, str]] = None) -> Any:
        data = raw_body if raw_body is not None else (
            json.dumps(body).encode() if body is not None else None)
        req = urllib.request.Request(uri + path, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self.auth_token:
            req.add_header("Authorization", f"Bearer {self.auth_token}")
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise RemoteError(msg, e.code) from e
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise NodeUnreachable(f"{uri}{path}: {e}") from e
        if not payload:
            return {}
        return json.loads(payload)

    # -- queries (reference: internal_client.go:602 QueryNode) ----------------

    def query_node(self, uri: str, index: str, ast: list,
                   shards: Optional[List[int]]) -> List[Any]:
        """Execute a pre-translated call list on one node's shards; returns
        tagged partial results (see cluster/wire.py)."""
        body = {"remote": True, "ast": ast, "shards": shards}
        resp = self._call(uri, "POST", f"/index/{index}/query", body)
        return resp.get("partials", [])

    # -- shard metadata --------------------------------------------------------

    def shards(self, uri: str, index: str) -> List[int]:
        resp = self._call(uri, "GET", f"/shards?index={index}")
        return resp.get("shards", [])

    # -- imports (reference: internal_client.go:860 import forwarding) --------

    def forward_import(self, uri: str, index: str, field: str, body: dict):
        self._call(uri, "POST", f"/index/{index}/field/{field}/import", body,
                   headers={"X-Featurebase-Forwarded": "1"})

    def forward_roaring(self, uri: str, index: str, shard: int, body: dict):
        self._call(uri, "POST", f"/index/{index}/shard/{shard}/import-roaring",
                   body, headers={"X-Featurebase-Forwarded": "1"})

    # -- key translation -------------------------------------------------------

    def translate_keys(self, uri: str, index: str, keys: List[str],
                       create: bool, field: str = "") -> Dict[str, int]:
        op = "create" if create else "find"
        if field:
            path = f"/internal/translate/field/{index}/{field}/keys/{op}"
        else:
            path = f"/internal/translate/index/{index}/keys/{op}"
        return self._call(uri, "POST", path, {"keys": keys})

    def translate_ids(self, uri: str, index: str, ids: List[int],
                      field: str = "") -> List[Optional[str]]:
        if field:
            path = f"/internal/translate/field/{index}/{field}/ids"
        else:
            path = f"/internal/translate/index/{index}/ids"
        return self._call(uri, "POST", path, {"ids": ids}).get("keys", [])

    def replicate_keys(self, uri: str, index: str, entries: Dict[str, int],
                       field: str = ""):
        """Push primary-assigned key->id entries to a replica (reference:
        translate replication, holder.go:1303 holderSyncer)."""
        if field:
            path = f"/internal/translate/field/{index}/{field}/replicate"
        else:
            path = f"/internal/translate/index/{index}/replicate"
        self._call(uri, "POST", path, {"entries": entries})

    # -- shard snapshots / resync (reference: internal_client.go:1012
    # fragment data streams; ctl/backup.go:342 shard snapshot fetch) ----------

    def _call_raw(self, uri: str, method: str, path: str,
                  raw_body: Optional[bytes] = None,
                  forwarded: bool = False) -> bytes:
        req = urllib.request.Request(uri + path, data=raw_body, method=method)
        req.add_header("Content-Type", "application/octet-stream")
        if forwarded:
            req.add_header("X-Featurebase-Forwarded", "1")
        if self.auth_token:
            req.add_header("Authorization", f"Bearer {self.auth_token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            raise RemoteError(str(e), e.code) from e
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            raise NodeUnreachable(f"{uri}{path}: {e}") from e

    def shard_checksums(self, uri: str, index: str, shard: int) -> dict:
        return self._call(uri, "GET",
                          f"/internal/index/{index}/shard/{shard}/fragments")

    def fragment_data(self, uri: str, index: str, shard: int, field: str,
                      view: str) -> bytes:
        """Single-fragment transfer — the block-granular anti-entropy unit
        (reference: internal_client.go:1012 fragment data stream)."""
        from urllib.parse import quote
        return self._call_raw(
            uri, "GET",
            f"/internal/index/{index}/shard/{shard}/fragment"
            f"?field={quote(field)}&view={quote(view)}", forwarded=True)

    def translate_checksums(self, uri: str) -> dict:
        return self._call(uri, "GET", "/internal/translate/checksums")

    def shard_snapshot(self, uri: str, index: str, shard: int) -> bytes:
        # forwarded: node-to-node fetches are local-only (no proxy chains)
        return self._call_raw(
            uri, "GET", f"/internal/index/{index}/shard/{shard}/snapshot",
            forwarded=True)

    def restore_shard(self, uri: str, index: str, shard: int, data: bytes,
                      forward: bool = False):
        """forward=False marks the request forwarded so the receiving node
        applies locally without re-fanning out (loop prevention)."""
        self._call_raw(uri, "POST", f"/internal/restore/{index}/{shard}",
                       raw_body=data, forwarded=not forward)

    def restore_translate(self, uri: str, snap: dict):
        self._call(uri, "POST", "/internal/translate/restore", {"snap": snap})

    # -- control plane ---------------------------------------------------------

    def cluster_message(self, uri: str, msg: dict):
        """Broadcast one typed message (reference: broadcast.go SendSync ->
        POST /internal/cluster/message)."""
        self._call(uri, "POST", "/internal/cluster/message", msg)

    def schema(self, uri: str) -> list:
        return self._call(uri, "GET", "/schema").get("indexes", [])

    def health(self, uri: str, timeout: float = 2.0) -> bool:
        try:
            req = urllib.request.Request(uri + "/health")
            with urllib.request.urlopen(req, timeout=timeout):
                return True
        except Exception:  # noqa: BLE001
            return False
