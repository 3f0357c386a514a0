"""The write clock of the plan executor's stacked leaves
(featurebase_tpu_torch/model/clock.py): a warm leaf is served without a
walk of its fragments, and every change a leaf could resolve to sends the
next check back to the walk, whose answer is the JAX package's.

Twin holders, one of each package, hold the same bits: the port's executor
keeps its caches warm across the changes, the JAX answers come from a
fresh JAX executor each time.  Walks are counted by wrapping
PlanExecutor._frag (each fragment lookup) and Fragment.pin_current (each
pin check), by field name.  Covered: a Set, a Clear, an import, a BSI
value, a new fragment inside the queried shard list, a fragment replaced
through API._restored, one removed, the field deleted and created again,
a view deleted; a write outside the queried shards (a walk, then a hit:
no storage.upload); a write after a pin (the pinned read is gathered
uncached and shows the pinned rows); a pin whose capture overlapped a
write (no clock: its reads walk); the mesh's Sharded leaves; writer and
reader threads sharing the clocks, no stale leaf left."""
import collections
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.core.consts import WORDS_PER_ROW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.fragment import Fragment as JaxFragment
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu_torch.executor.executor import Executor
from featurebase_tpu_torch.executor.plan import PlanExecutor
from featurebase_tpu_torch.model import snapshot
from featurebase_tpu_torch.model.field import FieldOptions
from featurebase_tpu_torch.model.fragment import Fragment
from featurebase_tpu_torch.model.index import Holder
from featurebase_tpu_torch.parallel.mesh import make_mesh
from featurebase_tpu_torch.server.api import API
from featurebase_tpu_torch.utils.tracing import TRACER

N = 400
QUERIES = ["Count(Row(f=1))", "Count(Row(v > 400))",
           "Sum(Row(f=1), field=v)", "Count(Intersect(Row(f=2), Row(g=1)))",
           "Row(f=1)"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Twins:
    """The same bits in a JAX holder and a port holder, index "c": f in
    shards 0-1 only, g and v in shards 0-2 (so shard 2 is in every query's
    list though f has no fragment there)."""

    def __init__(self, mesh=None):
        rng = np.random.default_rng(23)
        self.jax, self.port = JaxHolder(), Holder()
        f_cols = np.sort(rng.choice(2 * SW, N, replace=False))
        all_cols = np.sort(rng.choice(3 * SW, N, replace=False))
        f_rows = rng.integers(0, 3, N)
        g_rows = rng.integers(0, 2, N)
        vals = rng.integers(0, 1000, N)
        for h, opts in ((self.jax, JaxFieldOptions), (self.port,
                                                      FieldOptions)):
            idx = h.create_index("c")
            for name in ("f", "g"):
                idx.create_field(name)
            idx.create_field("v", opts(type="int", min=0, max=1000))
            idx.field("f").import_bits(f_rows, f_cols)
            idx.field("g").import_bits(g_rows, all_cols)
            idx.field("v").import_values(all_cols, vals)
            idx.mark_exists(np.union1d(f_cols, all_cols))
        self.ones = f_cols[f_rows == 1]     # columns with f=1
        self.e = Executor(self.port, mesh=mesh) if mesh else \
            Executor(self.port, device="cpu")

    def idx(self, side):
        return (self.jax if side == "jax" else self.port).index("c")

    def both(self, fn):
        for side in ("jax", "port"):
            fn(side, self.idx(side))

    def write(self, pql):
        JaxExecutor(self.jax).execute("c", pql)
        self.e.execute("c", pql)

    def answers(self, queries=QUERIES, shards=None):
        """(port, JAX) answers, the JAX package's from a cold executor."""
        return ([canon(self.e.execute("c", q, shards)[0]) for q in queries],
                [canon(JaxExecutor(self.jax).execute("c", q, shards)[0])
                 for q in queries])


def canon(r):
    if hasattr(r, "segments"):
        return ("row", r.columns().tolist())
    if hasattr(r, "val"):
        return ("valcount", int(r.val), int(r.count))
    return int(r)


@pytest.fixture
def walks(monkeypatch):
    """Fragment lookups and pin checks by field name, since the last
    clear()."""
    seen = collections.Counter()
    frag, pin_current = PlanExecutor._frag, Fragment.pin_current

    def counted_frag(f, view_name, shard):
        seen[f.name if f is not None else None] += 1
        return frag(f, view_name, shard)

    def counted_pin(self, pin):
        seen["pin:" + self.field] += 1
        return pin_current(self, pin)
    monkeypatch.setattr(PlanExecutor, "_frag", staticmethod(counted_frag))
    monkeypatch.setattr(Fragment, "pin_current", counted_pin)
    return seen


def warm(t):
    got, want = t.answers()
    assert got == want
    return got


def test_warm_leaf_served_without_a_walk(walks):
    t = Twins()
    warm(t)
    assert walks["f"] and walks["v"] and walks["g"]
    walks.clear()
    got, want = t.answers()
    assert got == want
    assert sum(walks.values()) == 0, walks


def _fragment_bits(package, view, shard, rows, cols):
    cls = JaxFragment if package == "jax" else Fragment
    words = np.zeros((len(rows), WORDS_PER_ROW), dtype=np.uint32)
    for i, c in enumerate(cols):
        words[i, c // 32] |= np.uint32(1 << (c % 32))
    return cls.from_npz_dict("c", "f", view, shard,
                             {"rows": np.array(rows, dtype=np.int64),
                              "words": words})


def set_bit(t):
    t.write(f"Set({2 * SW - 5}, f=1)")


def clear_bit(t):
    t.write(f"Clear({int(t.ones[0])}, f=1)")


def import_bits(t):
    t.both(lambda side, idx: idx.field("f").import_bits(
        np.array([1, 2, 1]), np.array([11, SW + 12, 13])))


def bsi_value(t):
    t.write(f"Set({int(t.ones[1])}, v=999)")


def new_fragment(t):
    def install(side, idx):
        idx.field("f").view("standard").fragments[2] = _fragment_bits(
            side, "standard", 2, [1, 2], [5, 6])
    t.both(install)


def restored(t):
    def replace(side, idx):
        v = idx.field("f").view("standard")
        old = v.fragments.pop(0)
        d = old.to_npz_dict()
        words = np.array(d["words"], copy=True)
        words[:, 1] ^= np.uint32(0xFFFF)
        if side == "jax":
            v.fragments[0] = JaxFragment.from_npz_dict(
                "c", "f", "standard", 0, {"rows": d["rows"],
                                          "words": words})
        else:
            API._restored("c", idx.field("f"), "standard", 0, d["rows"],
                          words, old)
    t.both(replace)


def removed(t):
    t.both(lambda side, idx: idx.field("f").view("standard")
           .fragments.pop(1))


def field_recreated(t):
    def again(side, idx):
        idx.delete_field("f")
        idx.create_field("f")
        idx.field("f").import_bits(np.array([1, 1, 2]),
                                   np.array([3, SW + 4, 2 * SW + 5]))
    t.both(again)


def view_deleted(t):
    t.both(lambda side, idx: idx.field("f").delete_view("standard"))


CHANGES = {"set": (set_bit, "f"), "clear": (clear_bit, "f"),
           "import": (import_bits, "f"), "bsi_value": (bsi_value, "v"),
           "new_fragment": (new_fragment, "f"), "restored": (restored, "f"),
           "removed": (removed, "f"),
           "field_recreated": (field_recreated, "f"),
           "view_deleted": (view_deleted, "f")}


@pytest.mark.parametrize("mesh", [None, 2], ids=["device", "mesh"])
@pytest.mark.parametrize("change", sorted(CHANGES))
def test_change_sends_the_next_check_to_the_walk(walks, change, mesh):
    """After each change the changed field's leaves walk once and answer
    as the JAX package; the other fields' leaves stay on the O(1) path; the
    check after that walks no more.  On a mesh the same, over Sharded
    leaves."""
    t = Twins(make_mesh(devices=["cpu"] * mesh) if mesh else None)
    before = warm(t)
    fn, field = CHANGES[change]
    fn(t)
    walks.clear()
    got, want = t.answers()
    assert got == want
    assert got != before
    assert walks[field] > 0, walks
    others = {"f", "g", "v"} - {field}
    assert not any(walks[o] for o in others), walks
    walks.clear()
    got, want = t.answers()
    assert got == want
    assert sum(walks.values()) == 0, walks


def test_write_outside_the_queried_shards_walks_and_hits(walks):
    t = Twins()
    shards = [0, 1]
    got, want = t.answers(shards=shards)
    assert got == want
    t.write(f"Set({2 * SW + 7}, f=1)")
    walks.clear()
    TRACER.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got, want = t.answers(shards=shards)
    totals = TRACER.totals()
    TRACER.reset()
    assert got == want
    assert walks["f"] > 0 and not walks["v"] and not walks["g"]
    assert totals["storage.leaf_walk"]["count"] > 0
    assert "storage.upload" not in totals
    walks.clear()
    t.answers(shards=shards)
    assert sum(walks.values()) == 0


def _columns(tile):
    """Columns of a (S, W) int32 stacked row."""
    bits = np.unpackbits(tile.numpy().view(np.uint8), axis=1,
                         bitorder="little")
    s, c = np.nonzero(bits)
    return (s * SW + c).tolist()


def test_pinned_read_after_a_write_is_gathered_uncached(walks):
    t = Twins()
    warm(t)
    idx = t.idx("port")
    pe = t.e.plan_executor
    shards = [0, 1, 2]
    cached = pe.stacked_field_rows(idx, "f", ("standard",), (1,), shards)
    col = 2 * SW - 9
    assert col not in t.ones
    pin = snapshot.pin_index(idx)
    try:
        assert pin.clock == idx.clock.value
        idx.field("f").set_bit(1, col)      # not yet in the JAX twin
        # a live read takes the write and the clock's new reading
        live = pe.stacked_field_rows(idx, "f", ("standard",), (1,), shards)
        with snapshot.pinned(pin):
            walks.clear()
            pinned = pe.stacked_field_rows(idx, "f", ("standard",), (1,),
                                           shards)
    finally:
        snapshot.release(pin)
    assert walks["f"] > 0 and walks["pin:f"] > 0
    assert pinned is not cached and pinned is not live
    want = canon(JaxExecutor(t.jax).execute("c", "Row(f=1)")[0])
    assert ("row", _columns(pinned[:, 0])) == want
    assert ("row", _columns(cached[:, 0])) == want
    assert ("row", _columns(live[:, 0])) == \
        ("row", sorted(want[1] + [col]))
    t.jax.index("c").field("f").set_bit(1, col)
    got, want = t.answers()
    assert got == want


def test_pin_overlapping_a_write_records_no_clock(walks):
    t = Twins()
    warm(t)
    idx = t.idx("port")
    pe = t.e.plan_executor
    cached = pe.stacked_field_rows(idx, "f", ("standard",), (1,), [0, 1, 2])
    clean = snapshot.pin_index(idx)
    snapshot.release(clean)
    assert clean.clock == idx.clock.value
    capture = idx.iter_fragments

    def capture_beside_a_write():
        for i, item in enumerate(capture()):
            if i == 1:
                idx.field("g").set_bit(1, 2 * SW + 1)
            yield item
    idx.iter_fragments = capture_beside_a_write
    pin = snapshot.pin_index(idx)
    del idx.iter_fragments
    try:
        assert pin.complete and pin.clock is None
        walks.clear()
        with snapshot.pinned(pin):
            again = pe.stacked_field_rows(idx, "f", ("standard",), (1,),
                                          [0, 1, 2])
    finally:
        snapshot.release(pin)
    assert walks["f"] > 0 and walks["pin:f"] > 0
    assert again is cached      # f unchanged: the walk's hit
    t.jax.index("c").field("g").set_bit(1, 2 * SW + 1)
    got, want = t.answers()
    assert got == want


def test_concurrent_writes_leave_no_stale_leaf():
    """Eight writer threads Set new columns of f while four readers query
    through the same executor (more threads than cores, a short switch
    interval): each reader's counts never fall, and afterwards the warm
    leaves answer as the JAX package after the same writes."""
    t = Twins()
    warm(t)
    ones = set(t.ones.tolist())
    new = [c for c in range(3, 2 * SW, 2 * SW // 97) if c not in ones][:64]
    base = t.e.execute("c", "Count(Row(f=1))")[0]
    counts = [[] for _ in range(4)]
    stop = threading.Event()

    def writer(cols):
        for c in cols:
            t.e.execute("c", f"Set({c}, f=1)")

    def reader(out):
        while not stop.is_set():
            out.append(t.e.execute("c", "Count(Row(f=1))")[0])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        readers = [threading.Thread(target=reader, args=(out,))
                   for out in counts]
        writers = [threading.Thread(target=writer, args=(new[i::8],))
                   for i in range(8)]
        for th in readers + writers:
            th.start()
        for th in writers:
            th.join(timeout=120)
        stop.set()
        for th in readers:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in readers + writers)
    for out in counts:
        assert out and all(a <= b for a, b in zip(out, out[1:]))
    for c in new:
        JaxExecutor(t.jax).execute("c", f"Set({c}, f=1)")
    got, want = t.answers()
    assert got == want
    assert got[0] == base + len(new)
