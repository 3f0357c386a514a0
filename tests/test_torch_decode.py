"""Kernels G and G' (plain versions, as the wrappers run them on the CPU),
expand_bits, pack_bits and the host decode against the JAX package.

The same seeded words go through featurebase_tpu/ops/bsi.py (decode_values,
decode_gather, expand_bits, pack_bits, decode_values_host,
expand_bits_host) and through featurebase_tpu_torch (ops/cuda_kernels.py
bsi_decode and bsi_decode_gather on CPU tensors, ops/decode.py) at depths
1, 14 and 31 on the int32 decode and 32, 43 and 62 on the host decode, and
through each package's Field.values_dense_host.  The data is integers:
every comparison is exact.  The int32 decode stops at depth 31 in both
packages, and every family that decodes switches to the host at 32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.ops import bsi as jbsi
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.ops import decode
from featurebase_tpu_torch.storage import snapshot

W = 96   # words a shard row in the module cases (3,072 columns)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64) \
        .astype(np.uint32)


def t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("depth", [1, 14, 31])
def test_decode_values_matches_jax(depth):
    rng = np.random.default_rng(depth)
    group = words(rng, (3, depth + 2, W))
    want = np.asarray(jbsi.decode_values(jnp.asarray(group[:, 2:]),
                                         jnp.asarray(group[:, 1]), depth))
    got = ck.bsi_decode(t32(group))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the jit form over the whole group (decode_values_jit)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbsi.decode_values_jit(jnp.asarray(group))))


@pytest.mark.parametrize("depth", [32, 43, 62])
def test_int32_decode_stops_at_31_in_both_packages(depth):
    rng = np.random.default_rng(depth)
    group = words(rng, (1, depth + 2, W))
    with pytest.raises(ValueError):
        jbsi.decode_values(jnp.asarray(group[:, 2:]),
                           jnp.asarray(group[:, 1]), depth)
    with pytest.raises(ValueError):
        ck.bsi_decode(t32(group))
    with pytest.raises(ValueError):
        ck.bsi_decode_gather(t32(group[0]), torch.zeros(1, dtype=torch.int64))


@pytest.mark.parametrize("depth", [1, 14, 31])
@pytest.mark.parametrize("n", [1, 37, 2048])
def test_decode_gather_matches_jax(depth, n):
    rng = np.random.default_rng(depth * 100 + n)
    group = words(rng, (depth + 2, W))
    cols = rng.choice(32 * W, n, replace=False).astype(np.int32)
    want_v, want_ok = (np.asarray(x) for x in jbsi.decode_gather(
        jnp.asarray(group[2:]), jnp.asarray(group[0]),
        jnp.asarray(group[1]), jnp.asarray(cols), depth))
    got_v, got_ok = ck.bsi_decode_gather(t32(group), torch.from_numpy(cols))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_ok.numpy(), want_ok)


def test_decode_gather_rejects_columns_outside_the_shard():
    group = t32(np.zeros((3, W), dtype=np.uint32))
    with pytest.raises(ValueError, match="columns"):
        ck.bsi_decode_gather(group, torch.tensor([32 * W]))


def test_expand_and_pack_bits_match_jax():
    rng = np.random.default_rng(5)
    w = words(rng, (2, 3, W))
    bits = decode.expand_bits(t32(w))
    want = np.asarray(jbsi.expand_bits(jnp.asarray(w)))
    np.testing.assert_array_equal(bits.numpy(), want)
    packed = decode.pack_bits(bits.bool())
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), w)
    np.testing.assert_array_equal(
        packed.numpy().view(np.uint32),
        np.asarray(jbsi.pack_bits(jnp.asarray(want.astype(bool)))))


@pytest.mark.parametrize("depth", [1, 14, 31, 32, 43, 62])
def test_host_decode_matches_jax(depth):
    rng = np.random.default_rng(depth + 7)
    slices, sign = words(rng, (depth, W)), words(rng, (W,))
    np.testing.assert_array_equal(
        decode.decode_values_host(slices, sign, depth),
        jbsi.decode_values_host(slices, sign, depth))
    np.testing.assert_array_equal(decode.expand_bits_host(sign),
                                  jbsi.expand_bits_host(sign))
    if depth <= 31:   # the host decode agrees with the int32 one
        group = np.concatenate([sign[None], sign[None], slices])
        np.testing.assert_array_equal(
            decode.decode_values_host(slices, sign, depth),
            ck.bsi_decode(t32(group[None]))[0].numpy())


def test_host_decode_past_62_raises():
    with pytest.raises(ValueError, match="62"):
        decode.decode_values_host(np.zeros((63, 4), np.uint32),
                                  np.zeros(4, np.uint32), 63)


@pytest.mark.parametrize("top_bits", [31, 32, 43, 62])
def test_field_values_dense_host_matches_jax(tmp_path, top_bits):
    """Each package's Field.values_dense_host and Field.value over the same
    saved field: values at both ends of the depth, signs and absent
    columns."""
    rng = np.random.default_rng(top_bits)
    top = (1 << top_bits) - 1
    holder = JaxHolder()
    idx = holder.create_index("i")
    idx.create_field("v", JaxFieldOptions(type="int", min=-top, max=top))
    cols = np.sort(rng.choice(2 * SW, 400, replace=False))
    vals = rng.integers(-top, top, 400, endpoint=True)
    vals[:4] = [top, -top, 0, -1]
    idx.field("v").import_values(cols, vals)
    path = str(tmp_path / "holder")
    jax_snapshot.save(holder, path)
    jf = idx.field("v")
    pf = snapshot.load(path).index("i").field("v")
    assert pf.bit_depth == jf.bit_depth == top_bits
    for shard in (0, 1, 2):
        want, got = jf.values_dense_host(shard), pf.values_dense_host(shard)
        if want is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    for c in [*cols[:6], cols[-1], 5 if 5 not in cols else 6]:
        assert pf.value(int(c)) == jf.value(int(c))
