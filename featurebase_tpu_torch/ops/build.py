"""Build and load the hand-written CUDA kernels (csrc/*.cu) and the host
C++ of native/ (bitops.cpp, roaring_codec.cpp).

Each source compiles with its toolchain (NVCC: nvcc for Hopper, sm_90a; GXX:
g++ -O3) into a shared library with a plain C interface under
featurebase_tpu_torch/build/, named by a hash of the source and flags so an
edited source never loads a stale build.  The library is written to a
temporary file of this process and moved into place with ``os.replace``, so
processes that build it at once each finish with a whole library.  It is
loaded with ctypes; callers pass device pointers and the stream as c_void_p.
The build runs at first use (never at import), and a failed build raises:
the port has no numpy fallback behind the C++ (the JAX package's native/
modules fall back quietly).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[Tuple[str, ...], ctypes.CDLL] = {}
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


@dataclass(frozen=True)
class Toolchain:
    """A compiler (its path, found at build time), its flags and the
    directory of its sources."""
    compiler: Callable[[], str]
    flags: Tuple[str, ...]
    src_dir: str


NVCC = Toolchain(nvcc_path, tuple(NVCC_FLAGS), CSRC)
GXX = Toolchain(lambda: "g++", ("-O3", "-shared", "-fPIC"),
                os.path.join(_PKG, "native"))


def library_path(source: str, flags: Tuple[str, ...] = (),
                 tc: Toolchain = NVCC) -> str:
    with open(os.path.join(tc.src_dir, source), "rb") as fh:
        digest = hashlib.sha1(fh.read()
                              + " ".join(tc.flags + tuple(flags)).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def _tmp(out: str) -> str:
    return f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"


def compile_source(source: str, flags: Tuple[str, ...] = (),
                   tc: Toolchain = NVCC) -> subprocess.Popen:
    """Start the compiler for one source (with extra `flags`, such as -D
    macros) into a temporary file; returns the process (chip_smoke.py
    starts every build at once)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(source, flags, tc)
    cmd = [tc.compiler(), *tc.flags, *flags, "-o", _tmp(out),
           os.path.join(tc.src_dir, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(source: str, proc: subprocess.Popen,
           flags: Tuple[str, ...] = (), tc: Toolchain = NVCC) -> str:
    """Wait for a compiler started by compile_source; raise on failure."""
    log, _ = proc.communicate()
    build_log[" ".join((source, *flags))] = log
    out = library_path(source, flags, tc)
    if proc.returncode != 0:
        name = os.path.basename(proc.args[0])
        raise RuntimeError(f"{name} failed for {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(_tmp(out), out)
    return out


def build(sources: List[str], flags: Tuple[str, ...] = (),
          tc: Toolchain = NVCC) -> None:
    """Compile every source not built yet, all compilers at once."""
    todo = [s for s in sources
            if not os.path.exists(library_path(s, flags, tc))]
    procs = [(s, compile_source(s, flags, tc)) for s in todo]
    for s, p in procs:
        finish(s, p, flags, tc)


def load(source: str, flags: Tuple[str, ...] = (), tc: Toolchain = NVCC,
         declare: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The loaded library for `source` built with `flags`, building it on
    first use; `declare` sets its functions' argument and result types
    once."""
    key = (tc.src_dir, source, *flags)
    lib: Optional[ctypes.CDLL] = _loaded.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            build([source], flags, tc)
            lib = ctypes.CDLL(library_path(source, flags, tc))
            if declare is not None:
                declare(lib)
            _loaded[key] = lib
        return lib
