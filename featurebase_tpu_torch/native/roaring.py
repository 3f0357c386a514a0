"""Pilosa-roaring codec: ctypes wrapper over the C++ codec
(roaring_codec.cpp), with the Python codec as its plain version.

Own copy of featurebase_tpu/native/roaring.py.  Decodes/encodes the
reference's wire format (reference: roaring/roaring.go cookie layout
:19-51, WriteTo:1730; container types array/bitmap/run) to and from dense
(key, 2048-uint32-words) containers.  Used by the roaring-compatible import
endpoints (reference api.go:618 ImportRoaring, 1647 ImportRoaringShard) and
export.  The library builds with g++ at first use (ops/build.py) and a
failed build raises; ``_decode_py``/``_encode_py`` are the plain versions
the tests hold it against, and ``encode`` takes them past 65,536 containers
as the JAX package does.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from featurebase_tpu_torch.ops import build

WORDS_PER_CONTAINER = 2048
_MAGIC = 12348


def _declare(lib: ctypes.CDLL) -> None:
    lib.roaring_container_count.restype = ctypes.c_longlong
    lib.roaring_container_count.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.roaring_decode.restype = ctypes.c_longlong
    lib.roaring_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_size_t]
    lib.roaring_encode.restype = ctypes.c_longlong
    lib.roaring_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t]


def _load() -> ctypes.CDLL:
    return build.load("roaring_codec.cpp", tc=build.GXX, declare=_declare)


def decode(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """pilosa-roaring bytes -> (keys (N,) uint64, words (N, 2048) uint32)."""
    if not data:
        return (np.empty(0, dtype=np.uint64),
                np.empty((0, WORDS_PER_CONTAINER), dtype=np.uint32))
    lib = _load()
    n = lib.roaring_container_count(data, len(data))
    if n < 0:
        raise ValueError("malformed roaring payload")
    keys = np.zeros(int(n), dtype=np.uint64)
    words = np.zeros((int(n), WORDS_PER_CONTAINER), dtype=np.uint32)
    if n:
        got = lib.roaring_decode(
            data, len(data),
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            int(n))
        if got != n:
            raise ValueError("malformed roaring payload")
    return keys, words


def encode(keys: np.ndarray, words: np.ndarray) -> bytes:
    """(keys, dense words) -> pilosa-roaring bytes."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n = len(keys)
    if n == 0:
        return b""
    if n <= 65536:
        lib = _load()
        cap = 8 + n * 16 + n * 8192 + n * 8
        out = np.zeros(cap, dtype=np.uint8)
        wrote = lib.roaring_encode(
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if wrote < 0:
            raise ValueError("encode failed")
        return out[:wrote].tobytes()
    return _encode_py(keys, words)


# ---------------------------------------------------------------------------
# The Python codec: the plain version
# ---------------------------------------------------------------------------

def _decode_py(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) < 8:
        raise ValueError("short roaring payload")
    cookie = int(buf[:4].view(np.uint32)[0])
    if cookie & 0xFFFF != _MAGIC or (cookie >> 16) & 0xFF != 0:
        raise ValueError("bad roaring cookie")
    n = int(buf[4:8].view(np.uint32)[0])
    keys = np.zeros(n, dtype=np.uint64)
    words = np.zeros((n, WORDS_PER_CONTAINER), dtype=np.uint32)
    hdr = 8
    offs_at = 8 + n * 12
    for i in range(n):
        h = buf[hdr + i * 12: hdr + (i + 1) * 12]
        keys[i] = h[:8].view(np.uint64)[0]
        typ = int(h[8:10].view(np.uint16)[0])
        card = int(h[10:12].view(np.uint16)[0]) + 1
        off = int(buf[offs_at + i * 4: offs_at + (i + 1) * 4].view(np.uint32)[0])
        if typ == 1:  # array
            vals = buf[off: off + card * 2].view(np.uint16).astype(np.int64)
            np.bitwise_or.at(words[i], vals >> 5,
                             np.uint32(1) << (vals & 31).astype(np.uint32))
        elif typ == 2:  # bitmap
            words[i] = buf[off: off + 8192].view(np.uint32)
        elif typ == 3:  # run
            rc = int(buf[off: off + 2].view(np.uint16)[0])
            runs = buf[off + 2: off + 2 + rc * 4].view(np.uint16).reshape(-1, 2)
            for start, last in runs:
                cols = np.arange(int(start), int(last) + 1, dtype=np.int64)
                np.bitwise_or.at(words[i], cols >> 5,
                                 np.uint32(1) << (cols & 31).astype(np.uint32))
        else:
            raise ValueError(f"bad container type {typ}")
    return keys, words


def _encode_py(keys: np.ndarray, words: np.ndarray) -> bytes:
    # choose types, mirror reference Optimize() heuristics
    import io
    live = []
    for i in range(len(keys)):
        w = words[i]
        bits = np.unpackbits(w.view(np.uint8), bitorder="little")
        card = int(bits.sum())
        if card == 0:
            continue
        d = np.diff(np.concatenate([[0], bits, [0]]))
        runs = int((d == 1).sum())
        run_size = 2 + 4 * runs
        arr_size = 2 * card
        if run_size < arr_size and run_size < 8192:
            typ = 3
        elif card <= 4096:
            typ = 1
        else:
            typ = 2
        live.append((int(keys[i]), typ, card, w, bits))
    out = io.BytesIO()
    out.write(np.array([_MAGIC, len(live)], dtype=np.uint32).tobytes())
    blobs = []
    for key, typ, card, w, bits in live:
        if typ == 1:
            blob = np.nonzero(bits)[0].astype(np.uint16).tobytes()
        elif typ == 2:
            blob = w.tobytes()
        else:
            d = np.diff(np.concatenate([[0], bits, [0]]))
            starts = np.nonzero(d == 1)[0]
            ends = np.nonzero(d == -1)[0] - 1
            rr = np.empty(2 * len(starts) + 1, dtype=np.uint16)
            rr[0] = len(starts)
            rr[1::2] = starts
            rr[2::2] = ends
            blob = rr.tobytes()
        blobs.append(blob)
        out.write(np.array([key], dtype=np.uint64).tobytes())
        out.write(np.array([typ, card - 1], dtype=np.uint16).tobytes())
    off = 8 + len(live) * 16
    for blob in blobs:
        out.write(np.array([off], dtype=np.uint32).tobytes())
        off += len(blob)
    for blob in blobs:
        out.write(blob)
    return out.getvalue()
