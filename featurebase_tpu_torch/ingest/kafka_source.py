"""Kafka consumer Source for the ingest kit, over the real wire protocol.

Reference: idk/kafka/source.go:1 — a librdkafka consumer with consumer-
group offset commit, JSON and Confluent-Avro record decoding.  Here the
client speaks the protocol directly (ingest/kafka_wire.py): manual
partition assignment (the "simple consumer" mode librdkafka also offers)
with OffsetFetch/OffsetCommit against the group coordinator, so committed
positions survive consumer restarts — the exactly-once checkpoint the
Ingester requires (ingest/idk.py: offsets commit only AFTER the batch
lands; see idk/ingest.go:1062 commitRecord).

Record decoding: JSON values, or Confluent-framed Avro (magic 0 + 4-byte
schema id + avro binary body) against a schema registry mapping
(reference: idk's schema-registry client).

Own copy of featurebase_tpu/ingest/kafka_source.py.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Callable, Dict, List, Optional, Union

from featurebase_tpu_torch.ingest import kafka_wire as kw
from featurebase_tpu_torch.ingest.idk import Source


class KafkaError(Exception):
    pass


class KafkaClient:
    """Single-broker protocol client (request/response over one socket)."""

    def __init__(self, host: str, port: int, client_id: str = "fb-tpu",
                 timeout: float = 30.0,
                 sasl_user: Optional[str] = None,
                 sasl_password: Optional[str] = None):
        self.host = host
        self.port = port
        self.client_id = client_id
        self._corr = 0
        self._lock = threading.Lock()
        # negotiated per-API max versions (ApiVersions v0 is safe against
        # every broker generation; flexible paths switch on when the
        # broker advertises them — KIP-482, VERDICT r3 #10)
        self.api_versions = {}
        self._sock = socket.create_connection((host, port), timeout=timeout)
        if sasl_user is not None:
            # SASL/PLAIN before anything else (reference deployment:
            # idk molecula-consumer-kafka-sasl)
            self.sasl_plain(sasl_user, sasl_password or "")

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

    def _request(self, api_key: int, api_version: int, body: bytes
                 ) -> kw.Reader:
        flexible = kw.is_flexible(api_key, api_version)
        with self._lock:
            self._corr += 1
            corr = self._corr
            enc = kw.encode_request_flexible if flexible \
                else kw.encode_request
            frame = enc(api_key, api_version, corr, self.client_id, body)
            self._sock.sendall(frame)
            hdr = self._read_exact(4)
            (size,) = struct.unpack(">i", hdr)
            payload = self._read_exact(size)
        r = kw.Reader(payload)
        got_corr = r.i32()
        if got_corr != corr:
            raise KafkaError(f"correlation mismatch {got_corr} != {corr}")
        if flexible and api_key != kw.API_API_VERSIONS:
            r.tags()  # response header v1 (ApiVersions stays v0)
        return r

    def negotiate(self) -> dict:
        """ApiVersions handshake (v0 — parseable by every broker
        generation); records each API's advertised max version so
        metadata()/fetch() pick the flexible encodings when offered."""
        r = self._request(kw.API_API_VERSIONS, 0, b"")
        err = r.i16()
        if err:
            raise KafkaError(f"ApiVersions error {err}")
        for (key, lo, hi) in r.array(
                lambda rr: (rr.i16(), rr.i16(), rr.i16())):
            self.api_versions[key] = (lo, hi)
        return dict(self.api_versions)

    def _max_version(self, api_key: int) -> int:
        return self.api_versions.get(api_key, (0, 0))[1]

    def sasl_plain(self, user: str, password: str):
        """SaslHandshake(v1, PLAIN) + SaslAuthenticate with the
        RFC 4616 [authzid] NUL authcid NUL passwd token."""
        r = self._request(kw.API_SASL_HANDSHAKE, 1,
                          kw.Writer().string("PLAIN").build())
        err = r.i16()
        if err:
            mechs = r.array(lambda rr: rr.string())
            raise KafkaError(
                f"SASL handshake error {err}; broker offers {mechs}")
        token = b"\x00" + user.encode() + b"\x00" + password.encode()
        r = self._request(kw.API_SASL_AUTHENTICATE, 0,
                          kw.Writer().bytes_(token).build())
        err = r.i16()
        msg = r.string()
        if err:
            raise KafkaError(f"SASL authentication failed: {msg}")

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise KafkaError("broker closed connection")
            buf += chunk
        return buf

    # -- APIs ----------------------------------------------------------------

    def metadata(self, topics: Optional[List[str]] = None) -> dict:
        if self._max_version(kw.API_METADATA) >= 9:
            return self._metadata_v9(topics)
        w = kw.Writer()
        w.array(topics or [], lambda w2, t: w2.string(t))
        r = self._request(kw.API_METADATA, 0, w.build())
        brokers = r.array(lambda rr: (rr.i32(), rr.string(), rr.i32()))

        def topic(rr):
            err = rr.i16()
            name = rr.string()
            parts = rr.array(lambda r3: (
                r3.i16(), r3.i32(), r3.i32(),
                r3.array(lambda r4: r4.i32()),
                r3.array(lambda r4: r4.i32())))
            return {"error": err, "name": name,
                    "partitions": [p[1] for p in parts]}
        return {"brokers": brokers, "topics": r.array(topic)}

    def _metadata_v9(self, topics: Optional[List[str]]) -> dict:
        """Flexible (compact) Metadata — KIP-482 encoding."""
        w = kw.Writer()
        if topics:
            w.compact_array(list(topics),
                            lambda w2, t: w2.compact_string(t).tags())
        else:
            w.compact_array(None, None)   # null = all topics
        w.i8(1)   # allow_auto_topic_creation
        w.i8(0)   # include_cluster_authorized_operations
        w.i8(0)   # include_topic_authorized_operations
        w.tags()
        r = self._request(kw.API_METADATA, 9, w.build())
        r.i32()   # throttle
        brokers = r.compact_array(
            lambda rr: (rr.i32(), rr.compact_string(), rr.i32(),
                        rr.compact_string(), rr.tags())[0:3]) or []
        r.compact_string()  # cluster id
        r.i32()             # controller id

        def topic(rr):
            err = rr.i16()
            name = rr.compact_string()
            rr.i8()  # is_internal
            parts = rr.compact_array(lambda r3: (
                r3.i16(), r3.i32(), r3.i32(), r3.i32(),
                r3.compact_array(lambda r4: r4.i32()),
                r3.compact_array(lambda r4: r4.i32()),
                r3.compact_array(lambda r4: r4.i32()),
                r3.tags())[0:2]) or []
            rr.i32()  # topic_authorized_operations
            rr.tags()
            return {"error": err, "name": name,
                    "partitions": [p[1] for p in parts]}
        out = {"brokers": brokers,
               "topics": r.compact_array(topic) or []}
        r.i32()  # cluster_authorized_operations (Metadata v8-v10 schema)
        r.tags()
        return out

    def produce(self, topic: str, partition: int,
                messages: List[tuple]) -> int:
        """messages: [(key bytes|None, value bytes|None)]; -> base offset."""
        mset = kw.encode_message_set(
            0, [(k, v, -1) for (k, v) in messages])
        w = kw.Writer()
        w.i16(1).i32(10000)
        w.array([topic], lambda w2, t:
                w2.string(t).array([partition], lambda w3, p:
                                   w3.i32(p).bytes_(mset)))
        r = self._request(kw.API_PRODUCE, 0, w.build())
        base = [-1]

        def topic_resp(rr):
            rr.string()
            def part_resp(r3):
                r3.i32()
                err = r3.i16()
                off = r3.i64()
                if err:
                    raise KafkaError(f"produce error {err}")
                base[0] = off
            rr.array(part_resp)
        r.array(topic_resp)
        return base[0]

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20) -> List[tuple]:
        """-> [(offset, key, value, timestamp)] from `offset` onward."""
        if self._max_version(kw.API_FETCH) >= 12:
            return self._fetch_v12(topic, partition, offset, max_bytes)
        w = kw.Writer()
        w.i32(-1).i32(0).i32(0)
        w.array([topic], lambda w2, t:
                w2.string(t).array([partition], lambda w3, p:
                                   w3.i32(p).i64(offset).i32(max_bytes)))
        r = self._request(kw.API_FETCH, 0, w.build())
        out: List[tuple] = []

        def topic_resp(rr):
            rr.string()
            def part_resp(r3):
                r3.i32()
                err = r3.i16()
                r3.i64()  # high watermark
                mset = r3.bytes_() or b""
                if err:
                    raise KafkaError(f"fetch error {err}")
                out.extend(kw.decode_message_set(mset))
            rr.array(part_resp)
        r.array(topic_resp)
        return out

    def _fetch_v12(self, topic: str, partition: int, offset: int,
                   max_bytes: int) -> List[tuple]:
        """Flexible Fetch with RecordBatch v2 payloads (KIP-482)."""
        w = kw.Writer()
        w.i32(-1)         # replica_id
        w.i32(0)          # max_wait_ms
        w.i32(0)          # min_bytes
        w.i32(max_bytes)  # max_bytes
        w.i8(0)           # isolation_level
        w.i32(0).i32(-1)  # session id / epoch
        w.compact_array([topic], lambda w2, t:
                        w2.compact_string(t)
                        .compact_array([partition], lambda w3, p:
                                       w3.i32(p).i32(-1).i64(offset)
                                       .i32(-1).i64(-1).i32(max_bytes)
                                       .tags())
                        .tags())
        w.compact_array([], lambda w2, x: None)  # forgotten topics
        w.compact_string("")                     # rack id
        w.tags()
        r = self._request(kw.API_FETCH, 12, w.build())
        r.i32()            # throttle
        top_err = r.i16()
        if top_err:
            raise KafkaError(f"fetch error {top_err}")
        r.i32()            # session id
        out: List[tuple] = []

        def topic_resp(rr):
            rr.compact_string()

            def part_resp(r3):
                r3.i32()
                err = r3.i16()
                r3.i64()   # high watermark
                r3.i64()   # last stable offset
                r3.i64()   # log start offset
                r3.compact_array(lambda r4: (r4.i64(), r4.i64(),
                                             r4.tags()))  # aborted txns
                r3.i32()   # preferred read replica
                recs = r3.compact_bytes() or b""
                r3.tags()
                if err:
                    raise KafkaError(f"fetch error {err}")
                for (off, key, value, ts) in \
                        kw.decode_record_batches(recs):
                    if off >= offset:
                        out.append((off, key, value, ts))
            rr.compact_array(part_resp)
            rr.tags()
        r.compact_array(topic_resp)
        r.tags()
        return out

    def offset_commit(self, group: str,
                      offsets: Dict[tuple, int]) -> None:
        by_topic: Dict[str, list] = {}
        for (topic, part), off in offsets.items():
            by_topic.setdefault(topic, []).append((part, off))
        w = kw.Writer()
        w.string(group)
        w.array(sorted(by_topic.items()), lambda w2, kv:
                w2.string(kv[0]).array(kv[1], lambda w3, po:
                                       w3.i32(po[0]).i64(po[1])
                                       .string("")))
        r = self._request(kw.API_OFFSET_COMMIT, 0, w.build())

        def topic_resp(rr):
            rr.string()
            def part_resp(r3):
                r3.i32()
                err = r3.i16()
                if err:
                    raise KafkaError(f"offset commit error {err}")
            rr.array(part_resp)
        r.array(topic_resp)

    def offset_fetch(self, group: str, topic: str,
                     partitions: List[int]) -> Dict[int, int]:
        w = kw.Writer()
        w.string(group)
        w.array([topic], lambda w2, t:
                w2.string(t).array(partitions, lambda w3, p: w3.i32(p)))
        r = self._request(kw.API_OFFSET_FETCH, 0, w.build())
        out: Dict[int, int] = {}

        def topic_resp(rr):
            rr.string()
            def part_resp(r3):
                p = r3.i32()
                off = r3.i64()
                r3.string()
                r3.i16()
                out[p] = off
            rr.array(part_resp)
        r.array(topic_resp)
        return out


# -- value deserializers -----------------------------------------------------

def json_deserializer(value: bytes) -> dict:
    return json.loads(value)


class AvroDeserializer:
    """Confluent wire framing + Avro binary decoding for record schemas.

    registry: {schema_id: schema} where schema is the parsed Avro record
    schema (dict with 'fields'), or a callable id -> schema.  Supports the
    primitives (null/boolean/int/long/float/double/bytes/string), nullable
    unions ['null', T], enums, and arrays of primitives — the shapes idk's
    recordizers consume (reference: idk/avro.go)."""

    def __init__(self, registry: Union[Dict[int, dict],
                                       Callable[[int], dict]]):
        self._lookup = registry if callable(registry) else registry.get

    def __call__(self, value: bytes) -> dict:
        if len(value) < 5 or value[0] != 0:
            raise KafkaError("not Confluent-framed Avro (magic != 0)")
        schema_id = struct.unpack(">i", value[1:5])[0]
        schema = self._lookup(schema_id)
        if schema is None:
            raise KafkaError(f"unknown schema id {schema_id}")
        dec = _AvroReader(value[5:])
        return dec.read(schema)


class _AvroReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _varint(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    def read(self, schema):
        if isinstance(schema, str):
            t = schema
        elif isinstance(schema, list):  # union
            idx = self._varint()
            return self.read(schema[idx])
        else:
            t = schema["type"]
            if t == "record":
                return {f["name"]: self.read(f["type"])
                        for f in schema["fields"]}
            if t == "enum":
                return schema["symbols"][self._varint()]
            if t == "array":
                out = []
                while True:
                    n = self._varint()
                    if n == 0:
                        break
                    if n < 0:
                        self._varint()  # block byte size
                        n = -n
                    out.extend(self.read(schema["items"])
                               for _ in range(n))
                return out
        if t == "null":
            return None
        if t == "boolean":
            b = self.data[self.pos]
            self.pos += 1
            return bool(b)
        if t in ("int", "long"):
            return self._varint()
        if t == "float":
            v = struct.unpack("<f", self.data[self.pos:self.pos + 4])[0]
            self.pos += 4
            return v
        if t == "double":
            v = struct.unpack("<d", self.data[self.pos:self.pos + 8])[0]
            self.pos += 8
            return v
        if t in ("bytes", "string"):
            n = self._varint()
            b = self.data[self.pos:self.pos + n]
            self.pos += n
            return b.decode() if t == "string" else b
        raise KafkaError(f"unsupported avro type {t!r}")


def avro_encode(schema: dict, record: dict, schema_id: int) -> bytes:
    """Confluent-framed Avro encoder (test/producer side)."""
    out = bytearray(b"\x00" + struct.pack(">i", schema_id))

    def zz(v: int):
        v = (v << 1) ^ (v >> 63)
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break

    def write(schema, val):
        if isinstance(schema, list):
            idx = 0 if val is None else next(
                i for i, s in enumerate(schema) if s != "null")
            zz(idx)
            return write(schema[idx], val)
        t = schema if isinstance(schema, str) else schema["type"]
        if t == "record":
            for f in schema["fields"]:
                write(f["type"], val[f["name"]])
        elif t == "null":
            pass
        elif t == "boolean":
            out.append(1 if val else 0)
        elif t in ("int", "long"):
            zz(int(val))
        elif t == "double":
            out.extend(struct.pack("<d", val))
        elif t == "float":
            out.extend(struct.pack("<f", val))
        elif t in ("string", "bytes"):
            b = val.encode() if isinstance(val, str) else val
            zz(len(b))
            out.extend(b)
        elif t == "enum":
            zz(schema["symbols"].index(val))
        elif t == "array":
            if val:
                zz(len(val))
                for x in val:
                    write(schema["items"], x)
            zz(0)
        else:
            raise KafkaError(f"unsupported avro type {t!r}")

    write(schema, record)
    return bytes(out)


class KafkaSource(Source):
    """Consumer-group Source over the wire protocol.

    Polls all partitions of `topic` round-robin from the group's committed
    offsets; commit() pushes the polled-through positions via
    OffsetCommit.  checkpoint() is the sum of committed offsets — a
    monotonic scalar for the auto-id allocator (ingest/idk.py)."""

    def __init__(self, bootstrap: str, topic: str, group: str = "fb-tpu",
                 deserializer: Optional[Callable[[bytes], dict]] = None,
                 client: Optional[KafkaClient] = None,
                 sasl_user: Optional[str] = None,
                 sasl_password: Optional[str] = None):
        host, _, port = bootstrap.partition(":")
        self.client = client or KafkaClient(host, int(port or 9092),
                                            sasl_user=sasl_user,
                                            sasl_password=sasl_password)
        self.topic = topic
        self.group = group
        self.deserializer = deserializer or json_deserializer
        md = self.client.metadata([topic])
        self.partitions = sorted(md["topics"][0]["partitions"])
        committed = self.client.offset_fetch(group, topic, self.partitions)
        # -1 = no committed offset: start from the beginning
        self._committed = {p: max(0, committed.get(p, -1))
                           for p in self.partitions}
        self._pos = dict(self._committed)

    def poll(self, max_records: int) -> List[dict]:
        out: List[dict] = []
        for p in self.partitions:
            if len(out) >= max_records:
                break
            msgs = self.client.fetch(self.topic, p, self._pos[p])
            for (off, _key, value, _ts) in msgs:
                if len(out) >= max_records:
                    break
                if value is not None:
                    out.append(self.deserializer(value))
                self._pos[p] = off + 1
        return out

    def checkpoint(self) -> int:
        return sum(self._committed.values())

    def commit(self) -> None:
        self.client.offset_commit(
            self.group, {(self.topic, p): self._pos[p]
                         for p in self.partitions})
        self._committed = dict(self._pos)

    def close(self) -> None:
        self.client.close()
