"""In-process Kafka broker stand-in speaking the real wire protocol.

Serves Produce/Fetch/Metadata/ListOffsets/OffsetCommit/OffsetFetch/
ApiVersions (v0, MessageSet v1) over TCP — the role idk's docker-compose
Kafka plays for the reference's integration tests (reference:
idk/docker-compose.yml, idk/kafka tests), runnable anywhere.  Topics
auto-create on first touch; logs and consumer-group offsets are in-memory
(optionally persisted to a JSON file so restarts keep committed offsets).

Own copy of featurebase_tpu/ingest/kafka_broker.py.
"""
from __future__ import annotations

import json
import os
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from featurebase_tpu_torch.ingest import kafka_wire as kw

ERR_NONE = 0
ERR_UNKNOWN_TOPIC = 3
ERR_OFFSET_OUT_OF_RANGE = 1
ERR_UNSUPPORTED_SASL_MECHANISM = 33
ERR_ILLEGAL_SASL_STATE = 34
ERR_SASL_AUTH_FAILED = 58


class _State:
    def __init__(self, num_partitions: int, offsets_path: Optional[str]):
        self.lock = threading.Lock()
        self.num_partitions = num_partitions
        # (topic, partition) -> list[(key, value, timestamp)]
        self.logs: Dict[Tuple[str, int], List[tuple]] = {}
        # (group, topic, partition) -> offset
        self.group_offsets: Dict[Tuple[str, str, int], int] = {}
        self.offsets_path = offsets_path
        if offsets_path and os.path.exists(offsets_path):
            with open(offsets_path) as fh:
                for k, v in json.load(fh).items():
                    g, t, p = k.split("\x00")
                    self.group_offsets[(g, t, int(p))] = int(v)

    def ensure_topic(self, topic: str):
        for p in range(self.num_partitions):
            self.logs.setdefault((topic, p), [])

    def persist_offsets(self):
        if not self.offsets_path:
            return
        data = {f"{g}\x00{t}\x00{p}": off
                for (g, t, p), off in self.group_offsets.items()}
        tmp = self.offsets_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, self.offsets_path)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        st: _State = self.server.state  # type: ignore[attr-defined]
        sock = self.request
        self.authenticated = False
        try:
            while True:
                hdr = self._read_exact(sock, 4)
                if hdr is None:
                    return
                (size,) = struct.unpack(">i", hdr)
                frame = self._read_exact(sock, size)
                if frame is None:
                    return
                r = kw.Reader(frame)
                api_key, api_version, corr, _client = \
                    kw.decode_request_header(r)
                if kw.is_flexible(api_key, api_version):
                    r.tags()  # request header v2 tagged fields
                body = self._dispatch(st, api_key, api_version, r)
                # flexible responses use header v1 (corr + tags) — except
                # ApiVersions, whose response header stays v0 so clients
                # can always parse it (the protocol's bootstrap quirk)
                hdr_tags = kw.is_flexible(api_key, api_version) \
                    and api_key != kw.API_API_VERSIONS
                sock.sendall(kw.encode_response(corr, body,
                                                header_tags=hdr_tags))
        except (ConnectionError, OSError):
            return

    @staticmethod
    def _read_exact(sock, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    # -- API impls -----------------------------------------------------------

    def _dispatch(self, st, api_key, api_version, r) -> bytes:
        flexible_broker = getattr(self.server, "flexible", True)
        users = getattr(self.server, "users", None)
        if api_key == kw.API_SASL_HANDSHAKE:
            # SASL/PLAIN negotiation (v1: tokens ride SaslAuthenticate;
            # reference deployment: idk kafka-sasl consumer)
            mech = r.string()
            w = kw.Writer()
            if (mech or "").upper() != "PLAIN":
                return w.i16(ERR_UNSUPPORTED_SASL_MECHANISM).array(
                    ["PLAIN"], lambda w2, m: w2.string(m)).build()
            return w.i16(ERR_NONE).array(
                ["PLAIN"], lambda w2, m: w2.string(m)).build()
        if api_key == kw.API_SASL_AUTHENTICATE:
            auth = r.bytes_() or b""
            parts = auth.split(b"\x00")
            w = kw.Writer()
            if len(parts) != 3:
                return w.i16(ERR_SASL_AUTH_FAILED).string(
                    "malformed PLAIN token").bytes_(b"").build()
            _authz, user, pw = (p.decode() for p in parts)
            if users is not None and users.get(user) != pw:
                return w.i16(ERR_SASL_AUTH_FAILED).string(
                    "bad credentials").bytes_(b"").build()
            self.authenticated = True
            return w.i16(ERR_NONE).string(None).bytes_(b"").build()
        if users is not None and not self.authenticated and \
                api_key != kw.API_API_VERSIONS:
            # an auth-required broker refuses everything but the
            # bootstrap APIs before SaslAuthenticate succeeds
            raise ConnectionError("unauthenticated request")
        if api_key == kw.API_API_VERSIONS:
            fx = flexible_broker
            apis = [(kw.API_PRODUCE, 0, 0),
                    (kw.API_FETCH, 0, 12 if fx else 0),
                    (kw.API_LIST_OFFSETS, 0, 0),
                    (kw.API_METADATA, 0, 9 if fx else 0),
                    (kw.API_OFFSET_COMMIT, 0, 0),
                    (kw.API_OFFSET_FETCH, 0, 0),
                    (kw.API_API_VERSIONS, 0, 3 if fx else 0),
                    (kw.API_SASL_HANDSHAKE, 0, 1),
                    (kw.API_SASL_AUTHENTICATE, 0, 0)]
            if api_version >= 3:
                # flexible request body: client software name/version
                r.compact_string()
                r.compact_string()
                r.tags()
                w = kw.Writer().i16(ERR_NONE)
                w.compact_array(apis, lambda w2, a:
                                w2.i16(a[0]).i16(a[1]).i16(a[2]).tags())
                w.i32(0)  # throttle_time_ms
                w.tags()
                return w.build()
            w = kw.Writer().i16(ERR_NONE)
            w.array(apis, lambda w2, a:
                    w2.i16(a[0]).i16(a[1]).i16(a[2]))
            return w.build()
        if api_key == kw.API_METADATA and api_version >= 9:
            t_entries = r.compact_array(
                lambda rr: (rr.compact_string(), rr.tags())[0])
            r.i8()  # allow_auto_topic_creation
            r.i8()  # include_cluster_authorized_operations
            r.i8()  # include_topic_authorized_operations
            r.tags()
            topics = list(t_entries) if t_entries else []
            with st.lock:
                if not topics:
                    topics = sorted({t for (t, _p) in st.logs})
                for t in topics:
                    st.ensure_topic(t)
                host, port = self.server.server_address[:2]
                w = kw.Writer()
                w.i32(0)  # throttle
                w.compact_array([(0, "127.0.0.1", port)], lambda w2, b:
                                w2.i32(b[0]).compact_string(b[1])
                                .i32(b[2]).compact_string(None).tags())
                w.compact_string("fb-tpu-cluster")
                w.i32(0)  # controller id

                def enc_topic9(w2, t):
                    w2.i16(ERR_NONE).compact_string(t).i8(0)
                    parts = list(range(st.num_partitions))
                    w2.compact_array(parts, lambda w3, p:
                                     w3.i16(ERR_NONE).i32(p).i32(0).i32(0)
                                     .compact_array([0],
                                                    lambda w4, x: w4.i32(x))
                                     .compact_array([0],
                                                    lambda w4, x: w4.i32(x))
                                     .compact_array([],
                                                    lambda w4, x: w4.i32(x))
                                     .tags())
                    w2.i32(-2147483648).tags()  # topic_authorized_ops
                w.compact_array(topics, enc_topic9)
                # cluster_authorized_operations: the Metadata v8-v10
                # schema carries this top-level int32 before the tagged
                # fields (INT32_MIN = not requested); omitting it only
                # parsed by coincidence (ADVICE r4 #3)
                w.i32(-2147483648)
                w.tags()
            return w.build()
        if api_key == kw.API_FETCH and api_version >= 12:
            r.i32()  # replica_id
            r.i32()  # max_wait
            r.i32()  # min_bytes
            r.i32()  # max_bytes
            r.i8()   # isolation_level
            r.i32()  # session_id
            r.i32()  # session_epoch

            def dec_topic(rr):
                topic = rr.compact_string()
                parts = rr.compact_array(lambda r3: (
                    r3.i32(), r3.i32(), r3.i64(), r3.i32(), r3.i64(),
                    r3.i32(), r3.tags())[0:6:])
                rr.tags()
                return topic, parts or []
            req_topics = r.compact_array(dec_topic) or []
            r.compact_array(lambda rr: (rr.compact_string(),
                                        rr.compact_array(
                                            lambda r3: r3.i32()),
                                        rr.tags()))  # forgotten
            r.compact_string()  # rack
            r.tags()
            out_topics = []
            with st.lock:
                for topic, parts in req_topics:
                    out_parts = []
                    for (part, _epoch, offset, _lfe, _lso, max_bytes) \
                            in parts:
                        log = st.logs.get((topic, part))
                        if log is None:
                            out_parts.append(
                                (part, ERR_UNKNOWN_TOPIC, 0, b""))
                            continue
                        hw = len(log)
                        if offset > hw:
                            out_parts.append(
                                (part, ERR_OFFSET_OUT_OF_RANGE, hw, b""))
                            continue
                        msgs = []
                        size = 0
                        for i in range(offset, hw):
                            key, value, ts = log[i]
                            size += 32 + len(key or b"") \
                                + len(value or b"")
                            if msgs and size > max_bytes:
                                break
                            msgs.append((key, value, ts))
                        recs = kw.encode_record_batch(offset, msgs) \
                            if msgs else b""
                        out_parts.append((part, ERR_NONE, hw, recs))
                    out_topics.append((topic, out_parts))
            w = kw.Writer()
            w.i32(0)        # throttle
            w.i16(ERR_NONE)  # top-level error
            w.i32(0)        # session id
            w.compact_array(out_topics, lambda w2, tp:
                            w2.compact_string(tp[0])
                            .compact_array(tp[1], lambda w3, pr:
                                           w3.i32(pr[0]).i16(pr[1])
                                           .i64(pr[2]).i64(pr[2])
                                           .i64(0)
                                           .compact_array(
                                               [], lambda w4, x: None)
                                           .i32(-1)
                                           .compact_bytes(pr[3] or None)
                                           .tags())
                            .tags())
            w.tags()
            return w.build()
        if api_key == kw.API_METADATA:
            topics = r.array(lambda rr: rr.string())
            with st.lock:
                if not topics:
                    topics = sorted({t for (t, _p) in st.logs})
                for t in topics:
                    st.ensure_topic(t)
                host, port = self.server.server_address[:2]
                w = kw.Writer()
                w.array([(0, "127.0.0.1", port)], lambda w2, b:
                        w2.i32(b[0]).string(b[1]).i32(b[2]))

                def enc_topic(w2, t):
                    w2.i16(ERR_NONE).string(t)
                    parts = list(range(st.num_partitions))
                    w2.array(parts, lambda w3, p:
                             w3.i16(ERR_NONE).i32(p).i32(0)
                             .array([0], lambda w4, x: w4.i32(x))
                             .array([0], lambda w4, x: w4.i32(x)))
                w.array(topics, enc_topic)
            return w.build()
        if api_key == kw.API_PRODUCE:
            r.i16()  # acks
            r.i32()  # timeout
            results = []
            n_topics = r.i32()
            with st.lock:
                for _ in range(n_topics):
                    topic = r.string()
                    st.ensure_topic(topic)
                    n_parts = r.i32()
                    for _ in range(n_parts):
                        part = r.i32()
                        mset = r.bytes_() or b""
                        msgs = kw.decode_message_set(mset)
                        log = st.logs.setdefault((topic, part), [])
                        base = len(log)
                        for (_off, key, value, ts) in msgs:
                            log.append((key, value,
                                        ts if ts >= 0
                                        else int(time.time() * 1000)))
                        results.append((topic, part, ERR_NONE, base))
            w = kw.Writer()
            by_topic: Dict[str, list] = {}
            for (t, p, e, o) in results:
                by_topic.setdefault(t, []).append((p, e, o))
            w.array(sorted(by_topic.items()), lambda w2, kv:
                    w2.string(kv[0]).array(kv[1], lambda w3, pr:
                                           w3.i32(pr[0]).i16(pr[1])
                                           .i64(pr[2])))
            return w.build()
        if api_key == kw.API_FETCH:
            r.i32()  # replica_id
            r.i32()  # max_wait
            r.i32()  # min_bytes
            n_topics = r.i32()
            out_topics = []
            with st.lock:
                for _ in range(n_topics):
                    topic = r.string()
                    n_parts = r.i32()
                    parts = []
                    for _ in range(n_parts):
                        part = r.i32()
                        offset = r.i64()
                        max_bytes = r.i32()
                        log = st.logs.get((topic, part))
                        if log is None:
                            parts.append((part, ERR_UNKNOWN_TOPIC, 0, b""))
                            continue
                        hw = len(log)
                        if offset > hw:
                            parts.append(
                                (part, ERR_OFFSET_OUT_OF_RANGE, hw, b""))
                            continue
                        msgs = []
                        size = 0
                        for i in range(offset, hw):
                            key, value, ts = log[i]
                            size += 26 + len(key or b"") + len(value or b"")
                            if msgs and size > max_bytes:
                                break
                            msgs.append((key, value, ts))
                        mset = kw.encode_message_set(offset, msgs)
                        parts.append((part, ERR_NONE, hw, mset))
                    out_topics.append((topic, parts))
            w = kw.Writer()
            w.array(out_topics, lambda w2, tp:
                    w2.string(tp[0]).array(tp[1], lambda w3, pr:
                                           w3.i32(pr[0]).i16(pr[1])
                                           .i64(pr[2]).bytes_(pr[3])))
            return w.build()
        if api_key == kw.API_LIST_OFFSETS:
            r.i32()  # replica
            n_topics = r.i32()
            out_topics = []
            with st.lock:
                for _ in range(n_topics):
                    topic = r.string()
                    n_parts = r.i32()
                    parts = []
                    for _ in range(n_parts):
                        part = r.i32()
                        tstamp = r.i64()
                        r.i32()  # max offsets
                        log = st.logs.get((topic, part), [])
                        off = 0 if tstamp == -2 else len(log)
                        parts.append((part, ERR_NONE, [off]))
                    out_topics.append((topic, parts))
            w = kw.Writer()
            w.array(out_topics, lambda w2, tp:
                    w2.string(tp[0]).array(tp[1], lambda w3, pr:
                                           w3.i32(pr[0]).i16(pr[1])
                                           .array(pr[2], lambda w4, o:
                                                  w4.i64(o))))
            return w.build()
        if api_key == kw.API_OFFSET_COMMIT:
            group = r.string()
            n_topics = r.i32()
            out_topics = []
            with st.lock:
                for _ in range(n_topics):
                    topic = r.string()
                    n_parts = r.i32()
                    parts = []
                    for _ in range(n_parts):
                        part = r.i32()
                        offset = r.i64()
                        r.string()  # metadata
                        st.group_offsets[(group, topic, part)] = offset
                        parts.append((part, ERR_NONE))
                    out_topics.append((topic, parts))
                st.persist_offsets()
            w = kw.Writer()
            w.array(out_topics, lambda w2, tp:
                    w2.string(tp[0]).array(tp[1], lambda w3, pr:
                                           w3.i32(pr[0]).i16(pr[1])))
            return w.build()
        if api_key == kw.API_OFFSET_FETCH:
            group = r.string()
            n_topics = r.i32()
            out_topics = []
            with st.lock:
                for _ in range(n_topics):
                    topic = r.string()
                    parts_req = r.array(lambda rr: rr.i32())
                    parts = []
                    for part in parts_req:
                        off = st.group_offsets.get((group, topic, part), -1)
                        parts.append((part, off, "", ERR_NONE))
                    out_topics.append((topic, parts))
            w = kw.Writer()
            w.array(out_topics, lambda w2, tp:
                    w2.string(tp[0]).array(tp[1], lambda w3, pr:
                                           w3.i32(pr[0]).i64(pr[1])
                                           .string(pr[2]).i16(pr[3])))
            return w.build()
        raise ValueError(f"unsupported kafka api {api_key}")


class KafkaBroker:
    """TCP broker; start()/stop(); .port for clients."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_partitions: int = 2,
                 offsets_path: Optional[str] = None,
                 flexible: bool = True,
                 users: Optional[dict] = None):
        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
        self.server = _Srv((host, port), _Handler)
        self.server.state = _State(num_partitions, offsets_path)
        # flexible=False caps advertised versions at the legacy set
        # (KIP-482 off: a pre-compact broker stand-in for tests)
        self.server.flexible = flexible
        # users={name: password} turns on mandatory SASL/PLAIN
        self.server.users = users
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def state(self) -> _State:
        return self.server.state  # type: ignore[attr-defined]

    def start(self) -> "KafkaBroker":
        t = threading.Thread(target=self.server.serve_forever, daemon=True)
        t.start()
        self._thread = t
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
