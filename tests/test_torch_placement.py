"""Owner placement (featurebase_tpu_torch.parallel.placement) and the
fields' placement gate, against the JAX package's.

The policy math (owner, owners, layout) equals featurebase_tpu's for 1,000
shards and one to four processes; the gate keeps host storage to the owned
shards while the shard set and candidate rows stay global (the
counterparts of tests/test_placement.py's TestPolicy and TestWriteGating);
and a mesh laid out in the owner-placed order, with its -1 sentinel shards
between the owners' runs, answers as one device does over the same gated
holder.
"""
import numpy as np
import pytest
import torch

from featurebase_tpu.parallel import placement as jax_placement
from featurebase_tpu_torch.core.consts import SHARD_WIDTH
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.model.field import FieldOptions
from featurebase_tpu_torch.model.index import Holder
from featurebase_tpu_torch.parallel import placement
from featurebase_tpu_torch.parallel.mesh import make_mesh


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clear_policy():
    yield
    placement.clear()
    jax_placement.clear()


def build(n=4000, shards=16, with_policy=None):
    if with_policy is not None:
        placement.configure(*with_policy)
    holder = Holder()
    idx = holder.create_index("pl")
    idx.create_field("f")
    idx.create_field("v", FieldOptions(type="int", min=0, max=1000))
    rng = np.random.default_rng(3)
    cols = np.sort(rng.choice(shards * SHARD_WIDTH, size=n, replace=False))
    fr = rng.integers(0, 4, size=n)
    vv = rng.integers(0, 1000, size=n)
    idx.field("f").import_bits(fr, cols)
    idx.field("v").import_values(cols, vv)
    idx.mark_exists(cols)
    return holder, idx, (cols, fr, vv)


@pytest.mark.parametrize("n_proc", [1, 2, 3, 4])
def test_policy_equals_jax(n_proc):
    shards = list(range(1000))
    for pid in range(n_proc):
        placement.configure(n_proc, pid, replicas=2)
        jax_placement.configure(n_proc, pid, replicas=2)
        assert [placement.owner("i", s) for s in shards] == \
            [jax_placement.owner("i", s) for s in shards]
        assert [placement.owners("i", s) for s in shards] == \
            [jax_placement.owners("i", s) for s in shards]
        assert [placement.owns("i", s) for s in shards] == \
            [jax_placement.owns("i", s) for s in shards]
        for n_dev in (n_proc, 2 * n_proc, 8):
            assert placement.layout("i", shards, n_dev) == \
                jax_placement.layout("i", shards, n_dev)


class TestPolicy:
    def test_owner_deterministic_and_stable(self):
        placement.configure(4, 0)
        a = [placement.owner("i", s) for s in range(64)]
        b = [placement.owner("i", s) for s in range(64)]
        assert a == b
        assert set(a) <= set(range(4))
        # growing the process count moves only a subset (jump-hash
        # monotonicity: a shard moves only TO the new process)
        moved = [s for s in range(64)
                 if placement.owner("i", s, 4) != placement.owner("i", s, 5)]
        assert 0 < len(moved) < 40
        for s in moved:
            assert placement.owner("i", s, 5) == 4

    def test_layout_alignment(self):
        placement.configure(2, 0)
        shards = list(range(10))
        lay = placement.layout("i", shards, n_devices=8)
        assert len(lay) % 8 == 0
        real = [s for s in lay if s >= 0]
        assert sorted(real) == shards
        # each process's owned shards occupy its contiguous half
        half = len(lay) // 2
        for pos, s in enumerate(lay):
            if s >= 0:
                assert placement.owner("i", s) == (0 if pos < half else 1)


class TestWriteGating:
    def test_host_storage_scoped_to_owned(self):
        holder, idx, (cols, fr, vv) = build(with_policy=(2, 0))
        owned = {s for s in range(16) if placement.owns("pl", s)}
        held = {sh for f in idx.fields.values()
                for v in f.views.values() for sh in v.fragments}
        assert held and held <= owned
        # global shard set + candidate rows stay agreed via metadata
        assert set(idx.available_shards()) == set(range(16))
        assert placement.active()
        assert idx.field("f").meta_rows(("standard",)) == {0, 1, 2, 3}

    def test_point_writes_gated(self):
        placement.configure(2, 1)
        holder = Holder()
        idx = holder.create_index("pl")
        idx.create_field("f")
        idx.create_field("v", FieldOptions(type="int"))
        shard = next(s for s in range(64) if not placement.owns("pl", s))
        col = shard * SHARD_WIDTH + 7
        assert idx.field("f").set_bit(3, col) is False
        assert idx.field("v").set_value(col, 1 << 19) is False
        assert not any(v.fragments for f in idx.fields.values()
                       for v in f.views.values())
        assert idx.available_shards() == [shard]
        assert idx.field("f").meta_rows(("standard",)) == {3}
        assert idx.field("v").bit_depth == 20

    def test_single_process_results_cover_owned_data_only(self):
        """With a policy active, a plain executor sees exactly the owned
        share; the global answer comes from the mesh."""
        holder, idx, (cols, fr, vv) = build(with_policy=(2, 1))
        e = Executor(holder, device="cpu")
        (count,) = e.execute("pl", "Count(Row(f=1))")
        owned_mask = np.array([placement.owns("pl", c >> 20) for c in cols])
        assert count == int(((fr == 1) & owned_mask).sum())


SENTINEL_MIX = [
    "Count(Row(f=1))", "Row(f=2)", "Sum(field=v)", "Sum(Row(f=0), field=v)",
    "Min(field=v)", "Max(Row(f=3), field=v)", "TopN(f)",
    "TopN(f, Row(v > 500))", "Rows(f)", "GroupBy(Rows(f))",
    "GroupBy(Rows(f), aggregate=Sum(field=v))", "Distinct(field=v)",
    "Distinct(Row(v < 100), field=f)", "Sort(All(), field=v, limit=5)",
    "Sort(Row(f=2), field=v, sort-desc=true, limit=3)",
    "Percentile(field=v, nth=50)", "Extract(Limit(Row(f=1), limit=20), "
    "Rows(f), Rows(v))", "Var(field=v)"]


def _canon(r):
    if type(r).__name__ == "SignedRow":
        return r.values().tolist()
    if hasattr(r, "segments"):
        return r.columns().tolist()
    if hasattr(r, "pairs"):
        return [(p.id, p.count) for p in r.pairs]
    if hasattr(r, "val"):
        return (r.val, r.count)
    if hasattr(r, "col_ids"):
        return (list(r.col_ids), [list(v) for v in r.field_values])
    if isinstance(r, list) and r and hasattr(r[0], "group"):
        return [(tuple(x.row_id for x in gc.group), gc.count, gc.agg)
                for gc in r]
    return r


def test_owner_placed_layout_equals_one_device():
    """A 4-member mesh in one process with the policy of process 0 of 2:
    the layout holds the owned shards then -1 sentinels in each process's
    half, and every family reads the sentinels as empty shards."""
    holder, idx, _ = build(n=3000, shards=11, with_policy=(2, 0))
    mesh_ex = Executor(holder, mesh=make_mesh(devices=["cpu"] * 4))
    one = Executor(holder, device="cpu")
    lay = mesh_ex.plan_executor.layout("pl", idx.available_shards())
    assert -1 in lay[:len(lay) // 2] and sorted(s for s in lay if s >= 0) \
        == list(range(11))
    for q in SENTINEL_MIX:
        assert _canon(mesh_ex.execute("pl", q)[0]) == \
            _canon(one.execute("pl", q)[0]), q
