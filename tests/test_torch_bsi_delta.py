"""The device BSI import delta: ops/bsi.py::bsi_delta_device (torch ops)
against the JAX package's bsi_delta_device (featurebase_tpu/ops/bsi.py:734)
and the port's host OR (Field._bsi_delta) at depths 1, 14 and 31 with
duplicate columns; Field._bsi_delta's route under
FEATUREBASE_TPU_DEVICE_INGEST (the device delta to depth 31, the host OR
at 32 and without the variable); and imports through both packages' APIs
with the variable set, answer for answer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurebase_tpu.ops.bsi import bsi_delta_device as jax_delta
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu_torch.model.field import Field
from featurebase_tpu_torch.ops import bsi as tbsi
from featurebase_tpu_torch.server.api import API as PortAPI
from test_torch_api import canon

SW = 1 << 20


def records(rng, n, depth, dup_frac=0.01):
    """Columns with dup_frac of them given twice (with other values),
    signed values of up to `depth` magnitude bits."""
    cols = rng.choice(SW, n, replace=False)
    k = max(1, int(n * dup_frac))
    cols = np.concatenate([cols, cols[:k]])
    hi = (1 << depth) - 1
    vals = rng.integers(-hi, hi + 1, cols.size)
    return cols.astype(np.int64), vals


@pytest.mark.parametrize("depth", [1, 14, 31])
def test_equals_the_jax_scatter_and_the_host_or(depth):
    rng = np.random.default_rng(depth)
    cols, vals = records(rng, 20_000, depth)
    mags = np.abs(vals)
    got = tbsi.bsi_delta_device(torch.from_numpy(cols),
                                torch.from_numpy(mags),
                                torch.from_numpy(vals < 0), depth)
    assert got.dtype == torch.int32 and got.shape == (depth + 2, SW // 32)
    got = got.numpy().view(np.uint32)
    want = np.asarray(jax_delta(jnp.asarray(cols, jnp.int32),
                                jnp.asarray(mags, jnp.uint32),
                                jnp.asarray(vals < 0, jnp.uint32), depth))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, Field._bsi_delta(cols, vals, mags.astype(np.uint64), depth))


def test_depth_32_is_refused():
    with pytest.raises(ValueError, match="depth <= 31"):
        tbsi.bsi_delta_device(torch.zeros(1, dtype=torch.int64),
                              torch.zeros(1, dtype=torch.int64),
                              torch.zeros(1, dtype=torch.bool), 32)


@pytest.mark.parametrize("env,depth,device_path", [
    ("1", 31, True), ("1", 32, False), ("1", 14, True), ("0", 14, False),
    (None, 14, False)])
def test_route_follows_the_variable_and_the_depth(monkeypatch, env, depth,
                                                  device_path):
    if env is None:
        monkeypatch.delenv("FEATUREBASE_TPU_DEVICE_INGEST", raising=False)
    else:
        monkeypatch.setenv("FEATUREBASE_TPU_DEVICE_INGEST", env)
    seen = []
    real = tbsi.bsi_delta_device

    def spy(cols, mags, neg, d):
        out = real(cols, mags, neg, d)
        seen.append(out.device)
        return out
    monkeypatch.setattr(tbsi, "bsi_delta_device", spy)
    rng = np.random.default_rng(depth)
    cols, vals = records(rng, 3000, depth)
    got = Field._bsi_delta(cols, vals, np.abs(vals).astype(np.uint64),
                           depth, torch.device("cpu"))
    assert seen == ([torch.device("cpu")] if device_path else [])
    monkeypatch.delenv("FEATUREBASE_TPU_DEVICE_INGEST", raising=False)
    np.testing.assert_array_equal(
        got, Field._bsi_delta(cols, vals, np.abs(vals).astype(np.uint64),
                              depth))


@pytest.mark.parametrize("bits", [14, 31, 40])
def test_api_imports_with_device_ingest_equal_the_jax_package(monkeypatch,
                                                              bits):
    """Both packages import the same values (duplicates and all, over two
    shards and two imports) with FEATUREBASE_TPU_DEVICE_INGEST=1: every
    answer equal (at 40 bits both take their host paths)."""
    monkeypatch.setenv("FEATUREBASE_TPU_DEVICE_INGEST", "1")
    rng = np.random.default_rng(bits)
    j, p = JaxAPI(), PortAPI(device="cpu")
    for api in (j, p):
        api.create_index("i")
        api.create_field("i", "v", {"type": "int"})
    for _ in range(2):
        cols, vals = records(rng, 4000, bits)
        cols = cols + (rng.integers(0, 2, cols.size) << 20)
        _, first = np.unique(cols, return_index=True)
        cols, vals = cols[first], vals[first]
        for api in (j, p):
            api.import_values("i", "v", cols, vals)
    for q in ["Sum(field=v)", "Min(field=v)", "Max(field=v)",
              "Count(Row(v > 0))", "Count(All())", "Row(v < -1000)"]:
        assert canon(p.query("i", q)) == canon(j.query("i", q)), q
