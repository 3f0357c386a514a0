"""The port's host C++ (native/bitops.cpp, native/roaring_codec.cpp built
by ops/build.py): tests/test_bitwise.py::TestNativeBitops on the port,
words_to_cols/cols_to_words against their numpy plain versions and the
JAX package, the build's naming, its race between processes and its
failure, which raises."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from featurebase_tpu.ops import bitwise as jbw
from featurebase_tpu_torch.native import bitops
from featurebase_tpu_torch.ops import build
from featurebase_tpu_torch.ops import bitwise as tbw
from torch_twins import twin_namespace

TestNativeBitops = twin_namespace("test_bitwise")["TestNativeBitops"]


def words(rng, n, density):
    w = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    w[rng.random(n) > density] = 0
    return w


@pytest.mark.parametrize("n,density,base", [
    (0, 0.5, 0), (1, 1.0, 7), (7, 0.5, 0), (32768, 0.001, 0),
    (32768, 0.3, 5 << 20), (32768, 1.0, 123), (2 * 32768, 0.02, 0)])
def test_words_to_cols_equals_plain_and_jax(n, density, base):
    rng = np.random.default_rng(n + int(density * 100))
    w = words(rng, n, density)
    got = tbw.words_to_cols(w, base=base)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, tbw.words_to_cols_plain(w, base))
    np.testing.assert_array_equal(got, jbw.words_to_cols(w, base=base))
    # int32 words (a device tensor's view) decode the same bits
    np.testing.assert_array_equal(
        tbw.words_to_cols(w.view(np.int32), base=base), got)


@pytest.mark.parametrize("n", [0, 1, 1000, 200_000])
def test_cols_to_words_equals_plain_and_jax(n):
    rng = np.random.default_rng(n)
    cols = rng.integers(0, 1 << 20, n)           # duplicates included
    got = tbw.cols_to_words(cols)
    assert got.dtype == np.uint32 and got.shape == (32768,)
    np.testing.assert_array_equal(got, tbw.cols_to_words_plain(cols))
    np.testing.assert_array_equal(got, jbw.cols_to_words(cols))
    np.testing.assert_array_equal(tbw.cols_to_words(cols, width=1 << 16),
                                  jbw.cols_to_words(cols, width=1 << 16))


def test_library_named_by_its_source():
    path = build.library_path("bitops.cpp", tc=build.GXX)
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith("libbitops-")
    bitops.words_to_cols(np.ones(2, np.uint32))
    assert os.path.exists(path)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILD = """
import dataclasses, sys
from featurebase_tpu_torch.ops import build
build.BUILD_DIR = sys.argv[1]
tc = dataclasses.replace(build.GXX, src_dir=sys.argv[2])
try:
    build.build([sys.argv[3]], tc=tc)
    print("ok", build.library_path(sys.argv[3], tc=tc))
except RuntimeError as e:
    print("err", str(e).splitlines()[0])
"""


def _race(tmp_path, source, here, n=6):
    """n processes started at once, each building `source` from `here`
    into one build directory: [(ok or err, library or message)]."""
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD, build_dir, here, source], cwd=ROOT,
        stdout=subprocess.PIPE, text=True) for _ in range(n)]
    outs = [p.communicate(timeout=300)[0].split(" ", 1) for p in procs]
    return build_dir, [(k, v.strip()) for k, v in outs]


def test_six_processes_race_on_one_build(tmp_path):
    """Six processes building the same library at once each finish with a
    whole library under the one name, and leave no temporary file."""
    build_dir, outs = _race(tmp_path, "bitops.cpp", build.GXX.src_dir)
    assert {o[0] for o in outs} == {"ok"}
    assert len({o[1] for o in outs}) == 1
    assert os.listdir(build_dir) == [os.path.basename(outs[0][1])]
    import ctypes
    lib = ctypes.CDLL(outs[0][1])
    assert lib.bitops_popcount is not None


def test_a_failed_build_raises(tmp_path):
    here = tmp_path / "src"
    here.mkdir()
    shutil.copy(os.path.join(build.GXX.src_dir, "bitops.cpp"), here)
    with open(here / "bitops.cpp", "a") as fh:
        fh.write("\nthis is not C++;\n")
    _, outs = _race(tmp_path, "bitops.cpp", str(here), n=2)
    assert [o[0] for o in outs] == ["err", "err"]
    assert "g++ failed for bitops.cpp" in outs[0][1]


@pytest.mark.parametrize("seed", range(4))
def test_run_counts_choose_the_container_types_the_jax_codec_does(seed):
    """Containers of runs crossing word boundaries, single bits, full and
    empty words: the port's encoder (runs counted a word at a time)
    writes the bytes of the JAX package's and of the Python codec."""
    from featurebase_tpu.native import roaring as jroaring
    from featurebase_tpu_torch.native import roaring as troaring
    rng = np.random.default_rng(seed)
    n = 64
    bits = np.zeros((n, 1 << 16), dtype=bool)
    for i in range(n):
        for _ in range(int(rng.integers(1, 3000 if i % 2 else 40))):
            a = int(rng.integers(0, 1 << 16))
            bits[i, a:a + int(rng.integers(1, 200 if i % 3 else 5))] = True
    words = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    keys = np.arange(n, dtype=np.uint64) * 3
    got = troaring.encode(keys, words)
    assert got == jroaring.encode(keys, words) == \
        troaring._encode_py(keys, words)
    k, w = troaring.decode(got)
    np.testing.assert_array_equal(w, words)
