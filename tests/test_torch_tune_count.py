"""The count-and tuning kernels of the port against the JAX tool's own.

tools/tune_count_kernel.py builds its three Pallas kernels as closures inside
main(), so the JAX tool is run in-process with runpy: sys.argv names its
variants, and pallas_call is wrapped to run in interpret mode and to record
each kernel with its keyword arguments.  The tool's own single-block parity
runs for every exact variant; its timing loop is cut short (the wrapper
raises for any grid wider than one block, and the tool reports that as an
error line and goes on).  Each recorded kernel then runs in interpret mode
on this file's numpy inputs, and the port's wrappers, given the same inputs
as CPU tensors, run their plain versions.  Tolerance: exact, mod 2^32 (the
results are int32 words that wrap).  The CUDA kernels themselves are held
against these plain versions on the card by chip_smoke.py.
"""
import contextlib
import io
import json
import os
import runpy
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from featurebase_tpu_torch.ops import tune_kernels as tk
from featurebase_tpu_torch.tools import tune_count_kernel as harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "tools", "tune_count_kernel.py")
SHAPES = [(256, 1024), (512, 1024)]
TOOL_VARIANTS = ["csa_256x1024", "direct_256x1024", "csa_p_256x1024",
                 "ceil_256x1024", "csa_512x1024", "direct_512x1024",
                 "csa_p_512x1024", "ceiling_dma"]
BUILDERS = {"build_ceiling": "tune_ceiling",
            "build_csa_smem": "tune_csa_scalar",
            "build_direct_partial": "tune_direct_partial",
            "build_csa_partial": "tune_csa_partial"}
ACCS = [0, 12345, (1 << 31) - 1000]   # the last one wraps


class _StopTiming(Exception):
    """Raised by the recording pallas_call for the tool's timing loops."""


@pytest.fixture(scope="module")
def jax_tool(tmp_path_factory):
    """Run the JAX tool; returns ({(builder, (rows, cols)): (kernel,
    kwargs)}, its printed lines)."""
    recorded = {}
    real_call, real_update = pl.pallas_call, jax.config.update

    def recording_call(kernel, **kw):
        builder = kernel.__qualname__.split(".<locals>.")[1]
        recorded.setdefault((builder, kw["in_specs"][1].block_shape),
                            (kernel, kw))
        if kw["grid"] != (1,):
            raise _StopTiming("timing skipped")
        return real_call(kernel, interpret=True, **kw)

    def no_cache(name, value):
        # the tool turns on a persistent compilation cache; keep this
        # process's JAX config as the other tests expect it
        if "cache" not in name:
            real_update(name, value)

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", recording_call)
        mp.setattr(jax.config, "update", no_cache)
        mp.setenv("HOME", str(tmp_path_factory.mktemp("home")))
        mp.setattr(sys, "argv", [TOOL] + TOOL_VARIANTS)
        with contextlib.redirect_stdout(out):
            runpy.run_path(TOOL, run_name="__main__")
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    return recorded, lines


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32) \
        .view(np.int32)


def run_jax(kernel, kw, a2, b2, acc) -> int:
    """One recorded Pallas kernel, in interpret mode, over (grid x rows,
    cols) inputs; the partial kernels' sum is taken as _partial_call
    (tools/tune_count_kernel.py:158) takes it."""
    rows, cols = kw["in_specs"][1].block_shape
    grid = (a2.shape[0] // rows,)
    kw = dict(kw, grid=grid)
    partial = kw["out_shape"].shape != (1, 1)
    if partial:
        kw["out_shape"] = jax.ShapeDtypeStruct((grid[0] * 8, cols), jnp.int32)
    res = pl.pallas_call(kernel, interpret=True, **kw)(
        np.array([[acc]], np.int32), a2, b2)
    if partial:
        res = jnp.sum(res, dtype=jnp.int32).reshape(1, 1)
    return int(np.asarray(res)[0, 0])


def port(name, a2, b2, acc) -> int:
    out = tk.KERNELS[name](torch.from_numpy(a2), torch.from_numpy(b2),
                           torch.tensor([[acc]], dtype=torch.int32))
    assert out.shape == (1, 1) and out.dtype == torch.int32
    return int(out[0, 0])


def i32(x: int) -> int:
    x %= 1 << 32
    return x - (1 << 32) if x >= 1 << 31 else x


def test_tool_recorded_every_kernel_and_passed_its_own_parity(jax_tool):
    recorded, lines = jax_tool
    assert set(recorded) == {(b, s) for b in BUILDERS for s in SHAPES}
    assert [ln["variant"] for ln in lines] == TOOL_VARIANTS
    for ln in lines:   # no "parity ... != ..." line: only the cut timing
        assert ln["error"] == "timing skipped", ln


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("builder", [b for b in BUILDERS
                                     if b != "build_ceiling"])
def test_count_kernels_match_jax(jax_tool, builder, shape, acc):
    kernel, kw = jax_tool[0][(builder, shape)]
    rows, cols = shape
    rng = np.random.default_rng(rows + acc % 97)
    a2, b2 = words(rng, (2 * rows, cols)), words(rng, (2 * rows, cols))
    want = run_jax(kernel, kw, a2, b2, acc)
    x = a2.view(np.uint32) & b2.view(np.uint32)
    assert want == i32(int(np.bitwise_count(x).sum()) + acc)
    assert port(BUILDERS[builder], a2, b2, acc) == want


@pytest.mark.parametrize("acc", ACCS)
@pytest.mark.parametrize("shape", SHAPES)
def test_ceiling_against_its_definitions(jax_tool, shape, acc):
    """The TPU ceiling folds only row 0 of each (rows, cols) block, because
    its DMA moves the whole block whatever the body touches; a GPU loads
    only the words a kernel uses, so the port's ceiling folds every word.
    Both values are pinned to numpy, and the TPU's equals the port's over
    the first row of each block."""
    kernel, kw = jax_tool[0][("build_ceiling", shape)]
    rows, cols = shape
    rng = np.random.default_rng(7 * rows + acc % 89)
    a2, b2 = words(rng, (2 * rows, cols)), words(rng, (2 * rows, cols))
    x = a2.view(np.uint32) ^ b2.view(np.uint32)
    tpu = run_jax(kernel, kw, a2, b2, acc)
    assert tpu == i32(int(x[::rows].sum(dtype=np.uint64)) + acc)
    assert port("tune_ceiling", np.ascontiguousarray(a2[::rows]),
                np.ascontiguousarray(b2[::rows]), acc) == tpu
    full = port("tune_ceiling", a2, b2, acc)
    assert full == i32(int(x.sum(dtype=np.uint64)) + acc)
    assert full != tpu


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 4099])
@pytest.mark.parametrize("name", sorted(tk.KERNELS))
def test_plain_versions_at_ragged_sizes(name, n):
    """The carry-save adder groups four words; the words after the last
    whole group are counted directly."""
    rng = np.random.default_rng(n)
    a, b = words(rng, (n,)), words(rng, (n,))
    x, y = a.view(np.uint32), b.view(np.uint32)
    acc = (1 << 31) - 3
    if name == "tune_ceiling":
        want = int((x ^ y).sum(dtype=np.uint64))
    else:
        want = int(np.bitwise_count(x & y).sum())
    assert port(name, a, b, acc) == i32(want + acc)


def test_int32_sum_of_partials_wraps():
    """The CUDA partial kernels' wrapper sums per-block uint32 partials with
    torch.sum(dtype=torch.int32), as the JAX tool sums with jnp.sum."""
    parts = np.array([(1 << 31) - 1, 5, 0xFFFFFFF0, 1 << 31], np.uint32)
    got = torch.sum(torch.from_numpy(parts.view(np.int32)), dtype=torch.int32)
    assert int(got) == i32(int(parts.astype(np.uint64).sum()))
    assert int(tk.wrap32(torch.tensor(5 * (1 << 32) - 1))) == -1


def test_cpu_tensors_launch_nothing():
    tk.reset_launches()
    x = torch.ones((64, 8), dtype=torch.int32)
    acc = torch.zeros((1, 1), dtype=torch.int32)
    for f in tk.KERNELS.values():
        for t, v in tk.SHAPES:
            f(x, x, acc, threads=t, vec=v)
    assert tk.launches() == {name: 0 for name in tk.KERNELS}


def test_wrappers_validate_inputs():
    x = torch.zeros(8, dtype=torch.int32)
    acc = torch.zeros((1, 1), dtype=torch.int32)
    for args, kw in [((x, x.to(torch.int64), acc), {}),
                     ((x, x[:4], acc), {}),
                     ((x, x, torch.zeros(2, dtype=torch.int32)), {}),
                     ((x, x, acc.to(torch.int64)), {}),
                     ((x, x, acc), {"threads": 96, "vec": 4})]:
        with pytest.raises(ValueError):
            tk.tune_csa_partial(*args, **kw)


def test_variant_names_mirror_the_jax_tool():
    assert harness.DEFAULT[:2] == ["ceiling_dma", "compiled_direct"]
    assert all(v in harness.VARIANTS for v in harness.DEFAULT)
    t, v = tk.DEFAULT_SHAPE
    for design in ("csa", "direct", "csa_p"):
        assert f"{design}_{t}x{v}" in harness.DEFAULT
        assert sum(d.rsplit("_", 1)[0] == design for d in harness.DEFAULT) \
            == 3
    assert harness.VARIANTS["ceiling_dma"] == ("tune_ceiling", t, v)
    assert "torch_direct" not in harness.DEFAULT


@pytest.mark.parametrize("variant", ["ceiling_256x1", "csa_1024x2",
                                     "direct_128x8", "csa_p_512x4",
                                     "torch_direct"])
def test_measure_on_cpu(variant):
    inputs = harness.make_inputs(64 << 10, torch.device("cpu"))
    line = harness.measure(variant, "cpu", inputs)
    assert line["variant"] == variant and line["device"] == "cpu"
    assert line["pct_3350"] is None
    kind, t, v = harness.VARIANTS[variant]
    block = t * v * 4 if t else inputs[0].numel()
    assert line["bytes"] == 2 * 4 * (inputs[0].numel() // block * block)
    assert line["exact"] == (kind != "tune_ceiling")


def test_cli_runs_on_cpu(capsys):
    rc = harness.main(["--device", "cpu", "ceiling_1024x2", "csa_p_256x8"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 0
    assert [ln["variant"] for ln in out] == ["ceiling_1024x2", "csa_p_256x8"]
    assert all(ln["device"] == "cpu" and ln["gb_per_s"] > 0 for ln in out)


def test_cli_exits_nonzero_when_a_variant_fails(capsys, monkeypatch):
    def wrong(a, b, acc, threads, vec):
        return tk.count_and_direct_plain(a, b, acc) + 1

    monkeypatch.setitem(tk.KERNELS, "tune_direct_partial", wrong)
    inputs = harness.make_inputs(64 << 10, torch.device("cpu"))
    monkeypatch.setattr(harness, "make_inputs", lambda *a, **k: inputs)
    rc = harness.main(["--device", "cpu", "direct_256x1", "csa_256x1"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rc == 1
    assert "parity" in out[0]["error"] and "gb_per_s" in out[1]
    with pytest.raises(SystemExit):
        harness.main(["--device", "cpu", "no_such_variant"])


def test_cli_needs_cuda_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        harness.main(["ceiling_dma"])


def test_harness_imports_neither_jax_nor_featurebase_tpu():
    code = (
        "import sys\n"
        "import featurebase_tpu_torch.tools.tune_count_kernel\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'featurebase_tpu' or m.startswith('featurebase_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
