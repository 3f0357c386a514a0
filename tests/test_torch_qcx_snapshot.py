"""tests/test_qcx_snapshot.py on the port's Executor on the CPU (the JAX
test bodies with featurebase_tpu_torch's Holder, Executor(device="cpu"),
snapshot pins, parser and ShardedGate): the shared/exclusive gate, pinned
reads over the MVCC overlay, no torn reads under concurrent writes, writes
under the shared gate, fragment generations, leaf-granular validation and
the seqlock, and test_restore_carries_generation_forward on the port's
API.shard_snapshot_bytes and API.restore_shard.  Its contract, that a
restored fragment never shows a generation a reader may already have
seen, is held here on the port's other restore path too: a checkpoint
reopened by API(data_dir=...)."""
import pytest
import torch

from featurebase_tpu_torch.server.api import API
from torch_twins import twin_namespace

globals().update(twin_namespace("test_qcx_snapshot", subs=[
    ("Executor(holder)", 'Executor(holder, device="cpu")'),
    ("        from featurebase_tpu.server.api import API\n"
     "        holder, idx, e = make_env()",
     "        from featurebase_tpu_torch.server.api import API\n"
     "        holder, idx, e = make_env()")]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reopened_fragment_never_reuses_a_generation(tmp_path):
    d = str(tmp_path / "node")
    api = API(device="cpu", data_dir=d)
    api.create_index("snap")
    api.create_field("snap", "f", {"type": "set"})
    api.query("snap", "Set(1, f=1)")
    api.checkpoint()
    before = api.holder.index("snap").field("f").view("standard") \
        .fragment(0).generation
    again = API(device="cpu", data_dir=d)
    frag = again.holder.index("snap").field("f").view("standard").fragment(0)
    assert frag.generation % 2 == 0
    assert frag.generation != before
    assert again.query("snap", "Count(Row(f=1))") == [1]
    again.query("snap", "Set(2, f=1)")
    assert frag.generation % 2 == 0 and frag.generation != before
    assert again.query("snap", "Count(Row(f=1))") == [2]
