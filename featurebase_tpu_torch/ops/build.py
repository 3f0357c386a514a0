"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for Hopper (sm_90a) into a shared library with
a plain C interface under featurebase_tpu_torch/build/, named by a hash of the
source so an edited kernel never loads a stale build.  The library is loaded
with ctypes; callers pass device pointers and the stream as c_void_p.  The
build runs at first use (never at import), and a failed nvcc raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build, by source
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME (or PyTorch's own CUDA home), else from PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path(source: str, flags: Tuple[str, ...] = ()) -> str:
    with open(os.path.join(CSRC, source), "rb") as fh:
        digest = hashlib.sha1(fh.read()
                              + " ".join(NVCC_FLAGS + list(flags)).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def _tmp(out: str) -> str:
    return f"{out}.{os.getpid()}.tmp"


def compile_source(source: str, flags: Tuple[str, ...] = ()
                   ) -> subprocess.Popen:
    """Start nvcc for one source (with extra `flags`, such as -D macros)
    into a temporary file; returns the process (chip_smoke.py starts every
    build at once)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(source, flags)
    cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", _tmp(out),
           os.path.join(CSRC, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(source: str, proc: subprocess.Popen,
           flags: Tuple[str, ...] = ()) -> str:
    """Wait for an nvcc started by compile_source; raise on failure."""
    log, _ = proc.communicate()
    build_log[" ".join((source, *flags))] = log
    out = library_path(source, flags)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(_tmp(out), out)
    return out


def build(sources: List[str], flags: Tuple[str, ...] = ()) -> None:
    """Compile every source not built yet, all nvcc processes at once."""
    todo = [s for s in sources if not os.path.exists(library_path(s, flags))]
    procs = [(s, compile_source(s, flags)) for s in todo]
    for s, p in procs:
        finish(s, p, flags)


def load(source: str, flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library for `source` built with `flags`, building it on
    first use."""
    with _lock:
        key = " ".join((source, *flags))
        lib: Optional[ctypes.CDLL] = _loaded.get(key)
        if lib is None:
            build([source], flags)
            lib = ctypes.CDLL(library_path(source, flags))
            _loaded[key] = lib
        return lib
