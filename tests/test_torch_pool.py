"""tests/test_worker_pool.py on the port (utils/pool.py::map_shards: in
parallel, in submission order, the first exception raised, the
submitting thread's contextvars in every job), and the executor's
per-shard fallbacks: unplannable filters under Count, TopN, Sum, Min/Max,
GroupBy, Extract, Sort and Distinct equal to the JAX executor, also while
a writer thread writes to the index, with every device cache consistent
afterwards.  Only the host Sort past depth 31 hands the pool its jobs (a
decode and a sort a shard); the interpreter's device words stay on the
submitting thread."""
import contextvars
import random
import threading
import time

import numpy as np
import pytest
import torch

from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu_torch.core.consts import SHARD_WIDTH as SW
from featurebase_tpu_torch.executor import executor as texec
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.model.field import FieldOptions
from featurebase_tpu_torch.model.index import Holder
from featurebase_tpu_torch.storage import residency
from featurebase_tpu_torch.utils import pool
from test_torch_api import canon
from torch_twins import twin_namespace

globals().update(twin_namespace(
    "test_worker_pool",
    subs=[("e = Executor(holder)", 'e = Executor(holder, device="cpu")')]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_results_in_submission_order_whatever_finishes_first():
    rnd = random.Random(3)
    delays = [rnd.random() * 0.02 for _ in range(40)]

    def job(i):
        time.sleep(delays[i])
        return i, threading.get_ident()
    out = pool.map_shards(job, list(range(40)))
    assert [i for i, _ in out] == list(range(40))
    assert len({t for _, t in out}) > 1


def test_jobs_see_the_submitting_threads_context():
    var = contextvars.ContextVar("v", default=None)
    var.set("query-7")
    assert pool.map_shards(lambda i: (i, var.get()), [0, 1, 2]) == \
        [(0, "query-7"), (1, "query-7"), (2, "query-7")]


N_SHARDS = 4

QUERIES = [
    "Count(Union(Row(f=1), Row(f=null)))",
    "Row(f=null)",
    "TopN(f, Union(Row(g=1), Row(f=null)))",
    "Sum(Row(f=null), field=v)",
    "Min(Union(Row(g=1), Row(f=null)), field=v)",
    "Max(Union(Row(g=1), Row(f=null)), field=v)",
    "GroupBy(Rows(f), filter=Union(Row(g=1), Row(f=null)))",
    "GroupBy(Rows(g), filter=Union(Row(g=1), Row(f=null)), "
    "aggregate=Sum(field=v))",
    "Extract(Union(Row(g=2), Row(f=null)), Rows(v))",
    "Sort(Union(Row(g=1), Row(f=null)), field=v, limit=10)",
    "Sort(Union(Row(g=1), Row(f=null)), field=b, limit=10)",
    "Sort(Row(f=null), field=b, sort-desc=true)",
    "Distinct(Union(Row(g=1), Row(f=null)), field=v)",
    "Count(Union(Row(f=null), Distinct(Row(g=3), field=v)))",
]


def build(pkg_holder, field_options, rng):
    holder = pkg_holder()
    idx = holder.create_index("p")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("w")
    idx.create_field("v", field_options(type="int", min=-500, max=500))
    idx.create_field("b", field_options(type="int", min=-(1 << 40),
                                        max=1 << 40))
    cols = np.sort(rng.choice(N_SHARDS * SW, size=4000, replace=False))
    has_f = rng.random(cols.size) < 0.7
    idx.field("f").import_bits(rng.integers(0, 5, has_f.sum()), cols[has_f])
    idx.field("g").import_bits(rng.integers(0, 4, cols.size), cols)
    idx.field("v").import_values(cols, rng.integers(-500, 501, cols.size))
    idx.mark_exists(cols)
    idx.field("b").import_values(cols[::3], rng.integers(
        -(1 << 40), 1 << 40, cols[::3].size))
    return holder, cols


@pytest.fixture(scope="module")
def pair():
    jh, cols = build(JaxHolder, JaxFieldOptions, np.random.default_rng(21))
    th, _ = build(Holder, FieldOptions, np.random.default_rng(21))
    return JaxExecutor(jh), Executor(th, device="cpu"), cols


POOLED = [q for q in QUERIES if "field=b" in q]


def test_fallbacks_run_on_the_pool(pair, monkeypatch):
    """The Sort past depth 31 hands a host job a shard to the pool; the
    other fallbacks, whose per-shard work is device words or a short host
    job, do not call it."""
    _, port, _ = pair
    assert len(POOLED) == 2
    calls = []

    def spy(fn, items):
        calls.append(len(items))
        return pool.map_shards(fn, items)
    monkeypatch.setattr(texec, "map_shards", spy)
    for q in QUERIES:
        n = len(calls)
        port.execute("p", q)
        assert (len(calls) > n) == (q in POOLED), q
    assert max(calls) == N_SHARDS


@pytest.mark.parametrize("q", QUERIES)
def test_pooled_fallbacks_equal_the_jax_executor(pair, q):
    jax_e, port, _ = pair
    assert canon(port.execute("p", q)) == canon(jax_e.execute("p", q))


def test_pooled_fallbacks_under_a_writer_thread(pair):
    """A writer thread sets bits of field w on existing records (which no
    query of the battery reads) while the battery runs through the pool
    three times: every answer equals the JAX executor's, and afterwards
    every fragment mirror is registered with the residency LRU under its
    byte size, the LRU's total is the sum of its entries, and a fresh
    executor answers the same."""
    jax_e, port, cols = pair
    want = {q: canon(jax_e.execute("p", q)) for q in QUERIES}
    stop = threading.Event()
    writes = [0]

    def writer():
        rng = np.random.default_rng(1)
        while not stop.is_set():
            c = int(rng.choice(cols))
            port.execute("p", f"Set({c}, w={int(rng.integers(0, 3))})")
            writes[0] += 1
            # a pause a write: a writer in a tight loop holds the GIL
            # through its switch interval after each release, and starves
            # any reader of the process, pooled or not
            time.sleep(0.0005)
    th = threading.Thread(target=writer)
    th.start()
    try:
        for _ in range(3):
            for q in QUERIES:
                assert canon(port.execute("p", q)) == want[q], q
    finally:
        stop.set()
        th.join()
    assert writes[0] > 0
    mgr = residency.residency()
    entries = dict(mgr._entries)
    assert mgr.bytes == sum(n for n, _ in entries.values())
    idx = port.holder.index("p")
    for f in idx.fields.values():
        for v in f.views.values():
            for fr in v.fragments.values():
                if fr._dev is not None and fr._dev.shape[0]:
                    assert entries[fr._residency_key()][0] == \
                        fr._dev.shape[0] * fr._dev.shape[1] * 4
                    np.testing.assert_array_equal(
                        fr.device_tile("cpu").numpy().view(np.uint32),
                        np.stack([fr.host_row(r) for r in fr.slot_rows()]))
    fresh = Executor(port.holder, device="cpu")
    for q in QUERIES:
        assert canon(fresh.execute("p", q)) == canon(port.execute("p", q))


def test_an_evicted_upload_leaves_a_newer_mirror_alone():
    """The residency LRU names the upload it evicts: a late eviction of an
    older upload of a fragment does not drop the newer mirror."""
    h = Holder()
    idx = h.create_index("e")
    f = idx.create_field("f")
    f.import_bits([1], [5])
    fr = f.view("standard").fragment(0)
    first = fr.device_tile("cpu")
    assert first.shape[0] == 1
    stale = fr._dev_upload
    f.import_bits([2], [6])        # a new slot: a full upload
    fr.device_tile("cpu")
    assert fr._dev_upload == stale + 1
    fr._evict_device(stale)
    assert fr._dev is not None and fr._dev.shape[0] == 2
    fr._evict_device(stale + 1)
    assert fr._dev is None


def test_launch_counts_lose_no_update_across_threads():
    """More threads than cores count launches at once, with the switch
    interval shortened: no increment is lost (ops/cuda_kernels.py
    _launched)."""
    import os
    import sys

    from featurebase_tpu_torch.ops import cuda_kernels as ck
    n_threads = 2 * (os.cpu_count() or 4)
    per = 2000
    before = ck.plan_eval.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [ck._launched(ck.plan_eval) for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ck.plan_eval.launches - before == n_threads * per
    ck.plan_eval.launches = before
