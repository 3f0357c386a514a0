"""The port's residency LRU and fragment device mirror.

The LRU scenarios of tests/test_residency.py run against both packages'
DeviceResidency and must behave the same (drop order, bytes, thrash).
Then the port's own users of it: the plan executor's leaf cache under a
small budget across many Options(shards=) lists, and a fragment's
device_tile() against its host words after each kind of write, on the
dirty-slot path and after an eviction (the full upload).  All on the CPU
device: the mirror logic is the same on a card."""
import numpy as np
import pytest
import torch

from featurebase_tpu.storage import residency as jax_res
from featurebase_tpu_torch.core.consts import (BSI_EXISTS_ROW, SHARD_WIDTH,
                                               WORDS_PER_ROW)
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.model import snapshot
from featurebase_tpu_torch.model.field import FieldOptions
from featurebase_tpu_torch.model.fragment import Fragment
from featurebase_tpu_torch.model.index import Holder
from featurebase_tpu_torch.storage import residency as res

CPU = torch.device("cpu")
ROW_BYTES = WORDS_PER_ROW * 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def mgr():
    yield res.reset(budget=8 * ROW_BYTES)
    res.reset()


# -- the LRU, against the reference's ------------------------------------------

def lru_order(mod):
    m = mod.DeviceResidency(budget=100)
    dropped = []
    m.add("a", 60, lambda: dropped.append("a"))
    m.add("b", 30, lambda: dropped.append("b"))
    m.touch("a")  # b becomes least recent
    m.add("c", 50, lambda: dropped.append("c"))
    return dropped, m.stats()


def oversized(mod):
    m = mod.DeviceResidency(budget=10)
    m.add("small", 5, lambda: None)
    m.add("big", 100, lambda: None)
    return m.stats()


def thrash(mod):
    m = mod.DeviceResidency(budget=100)
    state = {}
    for _ in range(3):
        for key in ("a", "b"):
            m.add(key, 80, lambda key=key: state.pop(key, None))
            state[key] = 80
    return sorted(state), m.stats()


def remove_and_budget(mod):
    m = mod.DeviceResidency(budget=100)
    dropped = []
    for k in "abcd":
        m.add(k, 20, lambda k=k: dropped.append(k))
    m.remove("b")
    m.set_budget(30)
    return dropped, m.stats()


@pytest.mark.parametrize("scenario", [lru_order, oversized, thrash,
                                      remove_and_budget])
def test_lru_behaves_as_the_reference(scenario):
    assert scenario(res) == scenario(jax_res)


def test_lru_order_and_protection():
    dropped, st = lru_order(res)
    assert dropped == ["b", "a"]  # b (least recent) then a; c protected
    assert st["entries"] == 1 and st["bytes"] == 50


def test_oversized_entry_allowed():
    st = oversized(res)
    assert st["bytes"] == 100 and st["entries"] == 1


def test_thrash_counts_reevictions():
    _, st = thrash(res)
    assert st["thrash"] >= 2 and st["largest"] == 80


def test_budget_from_env_and_default(monkeypatch):
    monkeypatch.setenv("FEATUREBASE_TPU_HBM_BUDGET", "12345")
    assert res.DeviceResidency().budget == 12345
    monkeypatch.delenv("FEATUREBASE_TPU_HBM_BUDGET")
    want = torch.cuda.mem_get_info()[1] // 2 if torch.cuda.is_available() \
        else 8 << 30
    assert res.DeviceResidency().budget == res.default_budget() == want
    assert res.DeviceResidency(budget=7).budget == 7


# -- the plan executor's leaf cache ----------------------------------------------

def small_holder(n_shards=6):
    rng = np.random.default_rng(9)
    cols = np.sort(rng.choice(n_shards * SHARD_WIDTH, size=3000,
                              replace=False))
    holder = Holder()
    idx = holder.create_index("r")
    idx.create_field("f")
    idx.create_field("v", FieldOptions(type="int", min=-50, max=50))
    idx.field("f").import_bits(rng.integers(0, 3, size=cols.size), cols)
    idx.field("v").import_values(cols, rng.integers(-50, 51, size=cols.size))
    idx.mark_exists(cols)
    return holder, cols


def test_leaf_cache_stays_within_budget_across_shard_lists(mgr):
    holder, _ = small_holder()
    lists = [[a, b] for a in range(6) for b in range(a + 1, 6)] + \
        [[a] for a in range(6)]
    queries = [q for shards in lists
               for q in (f"Options(Count(Row(f=1)), shards={shards})",
                         f"Options(Sum(Row(f=2), field=v), shards={shards})")]
    budget = mgr.budget
    mgr.set_budget(1 << 40)   # the answers, uncapped
    want = {q: Executor(holder, device="cpu").execute("r", q)[0]
            for q in queries}
    mgr.set_budget(budget)
    e = Executor(holder, device="cpu")
    for q in queries:
        assert e.execute("r", q)[0] == want[q], q
        st = mgr.stats()
        assert st["bytes"] <= budget or st["entries"] == 1, st
    st = mgr.stats()
    assert st["evictions"] > 0
    cached = sum(int(a.numel()) * 4
                 for _, a, _ in e.plan_executor._leaf_cache.values())
    assert cached <= budget


def test_pinned_gather_is_never_registered(mgr):
    holder, cols = small_holder(2)
    e = Executor(holder, device="cpu")
    idx = holder.index("r")
    pin = snapshot.pin_index(idx)
    try:
        idx.field("f").set_bit(1, int(cols[0]) + 1)   # pin now diverged
        with snapshot.pinned(pin):
            e.plan_executor.stacked_field_rows(idx, "f", ("standard",),
                                               (1,), [0, 1])
    finally:
        snapshot.release(pin)
    assert mgr.stats()["entries"] == 0
    assert not e.plan_executor._leaf_cache


def test_sum_and_count_share_the_resident_group(mgr):
    mgr.set_budget(1 << 40)
    holder, _ = small_holder(2)
    e = Executor(holder, device="cpu")
    e.execute("r", "Count(Row(v > 3)) Sum(field=v) Min(field=v)")
    bsi_keys = [k for k in e.plan_executor._leaf_cache if k[0] == "bsi"]
    assert len(bsi_keys) == 1


# -- the fragment's device mirror ------------------------------------------------

def fragment_with_rows():
    frag = Fragment("i", "f", "standard", 0)
    rng = np.random.default_rng(4)
    for r in range(3):
        frag.import_bits(np.full(50, r), rng.integers(0, SHARD_WIDTH, 50))
    return frag


def host_words(frag):
    return torch.from_numpy(
        frag._words[: frag.num_rows].copy().view(np.int32))


WRITES = {
    "set_bit": lambda fr: fr.set_bit(1, 777),
    "clear_bit": lambda fr: fr.clear_bit(2, int(np.flatnonzero(
        np.unpackbits(fr.host_row(2).view(np.uint8),
                      bitorder="little"))[0])),
    "import_bits": lambda fr: fr.import_bits(np.array([0, 2, 0]),
                                             np.array([5, 6, 99999])),
}


@pytest.mark.parametrize("path", ["dirty_slots", "after_eviction"])
@pytest.mark.parametrize("write", sorted(WRITES))
def test_device_tile_follows_host_words(mgr, write, path):
    frag = fragment_with_rows()
    before = frag.device_tile(CPU)
    assert torch.equal(before, host_words(frag))
    assert mgr.stats()["entries"] == 1
    if path == "after_eviction":
        mgr.set_budget(0)
        assert frag._dev is None and mgr.stats()["entries"] == 0
    snapshot_before = before.clone()
    WRITES[write](frag)
    if path == "dirty_slots":
        assert frag._dirty and not frag._all_dirty
    tile = frag.device_tile(CPU)
    assert torch.equal(tile, host_words(frag))
    assert not torch.equal(tile, snapshot_before)
    # a tensor handed out earlier never changes under its reader
    assert torch.equal(before, snapshot_before)
    mgr.set_budget(1 << 40)
    assert mgr.stats()["entries"] == 1


def test_new_row_takes_the_full_upload(mgr):
    frag = fragment_with_rows()
    frag.device_tile(CPU)
    frag.set_bit(7, 3)           # a fourth slot: the mirror is too short
    tile = frag.device_tile(CPU)
    assert tile.shape == (4, WORDS_PER_ROW)
    assert torch.equal(tile, host_words(frag))
    assert frag.slot_rows() == [0, 1, 2, 7]
    assert mgr.stats()["bytes"] == 4 * ROW_BYTES


def test_evicted_mirror_rebuilt_after_a_write_through_minrow(mgr):
    holder, cols = small_holder(3)
    e = Executor(holder, device="cpu")
    first = e.execute("r", "MaxRow(field=f)")[0]
    mgr.set_budget(0)            # every mirror and leaf evicted
    assert mgr.stats()["entries"] == 0
    mgr.set_budget(1 << 40)
    holder.index("r").field("f").set_bit(5, int(cols[0]))
    got = e.execute("r", "MaxRow(field=f)")[0]
    assert (first.pair.id, got.pair.id, got.pair.count) == (2, 5, 1)


def test_device_rows_and_row():
    frag = fragment_with_rows()
    tile, present = frag.device_rows([2, 9, 0], CPU)
    assert present.tolist() == [True, False, True]
    want = torch.stack([host_words(frag)[2],
                        torch.zeros(WORDS_PER_ROW, dtype=torch.int32),
                        host_words(frag)[0]])
    assert torch.equal(tile, want)
    assert torch.equal(frag.device_row(1, CPU), host_words(frag)[1])
    assert not frag.device_row(9, CPU).any()


def test_device_rows_of_consecutive_slots_keep_their_words():
    """Rows in consecutive slots come back as a view of the mirror; a later
    write replaces the mirror out of place and leaves the view as it was."""
    frag = fragment_with_rows()
    tile, present = frag.device_rows([1, 2], CPU)
    before = host_words(frag)[1:3]
    assert present.tolist() == [True, True] and torch.equal(tile, before)
    frag.set_bit(1, int(np.flatnonzero(
        np.unpackbits(frag.host_row(1).view(np.uint8),
                      bitorder="little") == 0)[0]))
    assert torch.equal(tile, before)
    assert torch.equal(frag.device_rows([1, 2], CPU)[0], host_words(frag)[1:3])


def test_device_tile_under_a_diverged_pin_serves_the_pinned_rows(mgr):
    holder, cols = small_holder(1)
    idx = holder.index("r")
    frag = idx.field("v").view("bsig_v").fragment(0)
    live_before = frag.device_tile(CPU).clone()
    pin = snapshot.pin_index(idx)
    try:
        col = int(np.flatnonzero(np.unpackbits(
            frag.host_row(BSI_EXISTS_ROW).view(np.uint8),
            bitorder="little") == 0)[0])
        frag.set_bit(BSI_EXISTS_ROW, col)
        with snapshot.pinned(pin):
            pinned = frag.device_tile(CPU)
            rows, present = frag.device_rows([BSI_EXISTS_ROW], CPU)
    finally:
        snapshot.release(pin)
    assert torch.equal(pinned, live_before)
    assert torch.equal(rows[0], live_before[frag.slot_rows().index(
        BSI_EXISTS_ROW)]) and present.tolist() == [True]
    assert torch.equal(frag.device_tile(CPU), host_words(frag))
