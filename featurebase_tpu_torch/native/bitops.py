"""ctypes wrapper for the C++ host-side bitmap hot paths (bitops.cpp).

Own copy of featurebase_tpu/native/bitops.py.  The library builds with g++
at first use (ops/build.py) and a failed build raises; the numpy bodies of
ops/bitwise.py (``words_to_cols_plain``, ``cols_to_words_plain``) are the
plain versions the tests hold these against.
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np

from featurebase_tpu_torch.ops import build


def _declare(lib: ctypes.CDLL) -> None:
    lib.bitops_words_to_cols.restype = ctypes.c_longlong
    lib.bitops_words_to_cols.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_size_t]
    lib.bitops_cols_to_words.restype = None
    lib.bitops_cols_to_words.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.bitops_popcount.restype = ctypes.c_longlong
    lib.bitops_popcount.argtypes = [ctypes.c_void_p, ctypes.c_size_t]


def _lib() -> ctypes.CDLL:
    if sys.byteorder != "little":
        raise RuntimeError("native bitops read words 64 bits at a time and "
                           "need a little-endian host")
    return build.load("bitops.cpp", tc=build.GXX, declare=_declare)


def words_to_cols(words: np.ndarray, base: int = 0) -> np.ndarray:
    """Sorted uint64 column ids (+ base) of the set bits of uint32 words
    (bit i of word k is column 32 k + i)."""
    lib = _lib()
    w = np.ascontiguousarray(words.reshape(-1), dtype=np.uint32)
    while True:
        n_set = int(lib.bitops_popcount(w.ctypes.data, w.size))
        out = np.empty(n_set, dtype=np.uint64)
        got = lib.bitops_words_to_cols(w.ctypes.data, w.size,
                                       ctypes.c_uint64(base),
                                       out.ctypes.data, n_set)
        if got == n_set:
            return out
        # the words changed between the count and the decode (a writer
        # on the caller's array): decode a private copy
        w = w.copy()


def cols_to_words(cols: np.ndarray, n_words: int) -> np.ndarray:
    """A dense (n_words,) uint32 vector with each column's bit set
    (columns outside [0, 32 n_words) are skipped)."""
    lib = _lib()
    c = np.ascontiguousarray(cols, dtype=np.int64)
    out = np.zeros(n_words, dtype=np.uint32)
    lib.bitops_cols_to_words(c.ctypes.data, c.size, out.ctypes.data,
                             out.size)
    return out
