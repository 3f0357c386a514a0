"""tests/test_hostmem.py's 5 tests on the port: the host-DRAM budget
(featurebase_tpu_torch/storage/hostmem.py) spills fragment host words to
disk and reloads them, and a dataset four times the budget answers every
call family through the port's Executor(device="cpu") as numpy does.
Besides: the same dataset under the same budget through the JAX Executor
and the port's gives equal answers, fragments_info reports spilled
fragments as the JAX API does, and a reload after a spill leaves the
generation, the device mirror and the plan executor's cached leaves
valid."""
import numpy as np
import pytest
import torch

from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.storage import hostmem as jax_hostmem
from featurebase_tpu_torch.core.consts import SHARD_WIDTH, WORDS_PER_ROW
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.model.field import FieldOptions
from featurebase_tpu_torch.model.index import Holder
from featurebase_tpu_torch.server.api import API
from featurebase_tpu_torch.storage import hostmem
from test_torch_api import canon
from torch_twins import twin_namespace

globals().update(twin_namespace("test_hostmem", subs=[
    ("Executor(holder)", 'Executor(holder, device="cpu")')]))

ROW_BYTES = WORDS_PER_ROW * 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def budgets():
    port = hostmem.reset(budget=16 * ROW_BYTES)
    jax = jax_hostmem.reset(budget=16 * ROW_BYTES)
    yield port, jax
    hostmem.reset()
    jax_hostmem.reset()


def seed(holder_cls, opts_cls):
    rng = np.random.default_rng(11)
    n = 12_000
    cols = np.sort(rng.choice(2 * SHARD_WIDTH, size=n, replace=False))
    holder = holder_cls()
    idx = holder.create_index("big")
    idx.create_field("f")
    idx.create_field("v", opts_cls(type="int", min=-50, max=500))
    idx.field("f").import_bits(rng.integers(0, 20, size=n), cols)
    idx.field("v").import_values(cols, rng.integers(-50, 500, size=n))
    idx.mark_exists(cols)
    return holder


SPILL_QUERIES = ["Count(Row(f=1))", "Sum(field=v)", "TopN(f, n=4)",
                 "GroupBy(Rows(f), limit=6)", "Min(field=v)",
                 "Count(Intersect(Row(f=2), Row(v > 100)))",
                 "Sort(All(), field=v, limit=4)"]


def test_spilled_answers_equal_the_jax_package(budgets):
    port, jax = budgets
    pe = Executor(seed(Holder, FieldOptions), device="cpu")
    je = JaxExecutor(seed(JaxHolder, JaxFieldOptions))
    assert port.stats()["evictions"] > 0 and jax.stats()["evictions"] > 0
    for q in SPILL_QUERIES:
        assert canon(pe.execute("big", q)) == canon(je.execute("big", q)), q
    assert port.stats()["reloads"] > 0


def test_reload_keeps_generation_mirror_and_leaves(budgets):
    """A spill and a reload are not writes: the generation stays, the
    device mirror is not rebuilt, and the plan executor answers from its
    cached leaf (the same tensor) with the same count."""
    holder = seed(Holder, FieldOptions)
    e = Executor(holder, device="cpu")
    (want,) = e.execute("big", "Count(Row(f=3))")
    frag = holder.index("big").field("f").view("standard").fragment(0)
    gen, mirror = frag.generation, frag.device_tile("cpu")
    cached = dict(e.plan_executor._leaf_cache)
    frag._offload_host()
    assert frag._words_mem is None
    frag._reload_host()
    assert frag.generation == gen
    assert frag.device_tile("cpu") is mirror
    assert e.execute("big", "Count(Row(f=3))") == [want]
    for k, (g, arr) in cached.items():
        hit = e.plan_executor._leaf_cache.get(k)
        assert hit is not None and hit[0] == g and hit[1] is arr, k


def test_fragments_info_reports_spills(budgets):
    api = API(device="cpu")
    api.create_index("h")
    api.create_field("h", "f", {"type": "set"})
    api.import_bits("h", "f", [1, 2], [5, 7 + SHARD_WIDTH])
    frag = api.holder.index("h").field("f").view("standard").fragment(1)
    frag._offload_host()
    info = {(r["field"], r["shard"]): r for r in api.fragments_info("h")}
    assert info[("f", 1)]["spilled"] and info[("f", 1)]["hostBytes"] == 0
    assert not info[("f", 0)]["spilled"]
    assert info[("f", 0)]["hostBytes"] > 0
    assert api.query("h", "Count(Row(f=2))") == [1]     # reloads
    info = {(r["field"], r["shard"]): r for r in api.fragments_info("h")}
    assert not info[("f", 1)]["spilled"]


def test_touch_keeps_the_lru_order_and_the_last_key_takes_no_lock():
    """Eviction goes in the order of the last touch; touching the key last
    moved to the end again returns without the manager's lock."""
    import threading
    gone = []
    m = hostmem.HostResidency(budget=300)
    for k in "abc":
        m.add(k, 100, lambda k=k: gone.append(k))
    m.touch("a")
    m.touch("a")
    m.touch("b")                                   # c, a, b
    m.add("d", 100, lambda: gone.append("d"))      # evicts c
    m.touch("a")                                   # b, d, a
    m.add("e", 100, lambda: gone.append("e"))      # evicts b
    assert gone == ["c", "b"]
    m.touch("d")
    with m._lock:
        t = threading.Thread(target=m.touch, args=("d",))
        t.start()
        t.join(timeout=5)
        assert not t.is_alive()
    m.add("f", 100, lambda: gone.append("f"))      # a, e, d, f: evicts a
    assert gone == ["c", "b", "a"]
