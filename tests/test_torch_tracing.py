"""The port's spans (featurebase_tpu_torch/utils/tracing.py) on the query
path of API.query, on the CPU.

- With no profiler and no profile nothing is recorded and no profiler range
  opens; a span is then one shared object that allocates nothing.
- The Options(profile=true) tree is the JAX package's, span for span, with
  the profiler recording or not.
- Under torch.profiler (every thread, as portbench starts it) a query sent
  from a second thread puts each span's range on that thread inside its
  `query` range; every span carries the query's tracker id and leads to
  its root, and the self times partition `query`.
- A stacked leaf uploads once, is then served by the cache, and uploads
  again after a write to one of its fragments; a fragment mirror's upload
  has a span of its own and is no leaf's miss.
- One measurement, the `query` span's, feeds query_seconds and the
  tracker's runtime."""
import itertools
import threading
import tracemalloc

import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, record_function

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.core.consts import WORDS_PER_ROW
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu_torch.server.api import API, APIError
from featurebase_tpu_torch.utils import tracing
from featurebase_tpu_torch.utils.metrics import REGISTRY
from featurebase_tpu_torch.utils.pool import map_shards
from featurebase_tpu_torch.utils.tracing import OFF, TRACER

QUERIES = {
    "sum": "Sum(Row(f=1), field=v)",
    "count": "Count(Intersect(Row(f=1), Row(g=1)))",
    "groupby": "GroupBy(Rows(f), Rows(g))",
}

# spans each query must open, beside `query`, `query.parse` and
# `executor.execute`
SPANS = {
    "sum": {"executor.executeSum", "plan.compile", "storage.leaf",
            "storage.upload", "plan.lower", "kernel.plan_eval",
            "kernel.bsi_sum_planes", "device.wait", "agg.finish"},
    "count": {"executor.executeCount", "plan.compile", "storage.leaf",
              "storage.upload", "plan.lower", "kernel.plan_eval",
              "device.wait"},
    "groupby": {"executor.executeGroupBy", "storage.leaf", "storage.upload",
                "kernel.pair_counts", "device.wait",
                "agg.finish"},
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_totals():
    TRACER.reset()
    yield
    TRACER.reset()


def seed(api):
    api.create_index("i")
    api.create_field("i", "f", {"type": "set"})
    api.create_field("i", "g", {"type": "set"})
    api.create_field("i", "v", {"type": "int", "min": 0, "max": 1000})
    cols = [1, 2, 7, SW + 3, SW + 9, 2 * SW + 5, 2 * SW + 6]
    api.import_bits("i", "f", [1, 1, 2, 1, 2, 1, 1], cols)
    api.import_bits("i", "g", [1, 2, 1, 1, 1, 2, 1], cols)
    api.import_values("i", "v", cols, [10, 20, 50, 30, 40, 60, 70])
    return api


@pytest.fixture
def port():
    return seed(API(device="cpu"))


def all_threads():
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def on_thread(fn):
    """fn() on a second thread, under the label "client"."""
    out = []

    def run():
        with record_function("client"):
            out.append(fn())
    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    return out[0]


@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_off_records_nothing(port, monkeypatch, kind):
    opened = []
    monkeypatch.setattr(tracing, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    port.query("i", QUERIES[kind])
    assert TRACER.totals() == {}
    assert opened == []


@pytest.mark.parametrize("opener", ["span", "start_span", "nested"])
def test_off_span_is_shared_and_allocates_nothing(opener):
    def once():
        if opener == "span":
            with TRACER.span("storage.leaf"):
                pass
        elif opener == "start_span":
            with TRACER.start_span("executor.execute", "Count"):
                pass
        else:
            with TRACER.start_span("executor.execute", "Sum"):
                with TRACER.span("storage.leaf"):
                    pass
    assert TRACER.span("storage.leaf") is OFF
    assert TRACER.start_span("executor.execute", "Count") is OFF
    once()
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in itertools.repeat(None, 2000):
            once()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after == before
    assert peak - before < 512     # no allocation a span (2000 of them)
    assert TRACER.totals() == {}


def span_names(span):
    return [span.get("name"), sorted(span),
            [span_names(c) for c in span.get("children", [])]]


@pytest.mark.parametrize("profiler", [False, True])
@pytest.mark.parametrize("pql", [
    "Options(Count(Row(f=1)), profile=true)",
    "Options(Sum(Row(f=1), field=v), profile=true)",
    "Options(GroupBy(Rows(f), Rows(g)), profile=true)",
    "Options(Count(Row(f=1)), profile=true) Count(Row(g=1))",
])
def test_profile_tree_unchanged(port, pql, profiler):
    jax = seed(JaxAPI())
    want = jax.query_full("i", pql)
    if profiler:
        with all_threads():
            got = port.query_full("i", pql)
        assert "query" in TRACER.totals()
    else:
        got = port.query_full("i", pql)
    assert span_names(got["profile"]) == span_names(want["profile"])
    assert got["profile"]["tags"] == {"index": "i"}
    assert len(got["results"]) == len(want["results"])


@pytest.mark.parametrize("kind", sorted(QUERIES))
def test_spans_on_the_client_thread(port, monkeypatch, kind):
    spans, qids = [], []
    record = tracing.Tracer._record
    monkeypatch.setattr(tracing.Tracer, "_record",
                        lambda self, s: (spans.append(s), record(self, s)))
    start = port.tracker.start
    monkeypatch.setattr(port.tracker, "start",
                        lambda *a: qids.append(start(*a)) or qids[-1])
    with all_threads() as prof:
        on_thread(lambda: port.query("i", QUERIES[kind]))
    (qid,) = qids
    (root,) = [s for s in spans if s.name == "query"]
    assert {s.name for s in spans} >= SPANS[kind] | {
        "query", "query.parse", "executor.execute"}
    for s in spans:
        assert s.qid == qid
        chain = s
        while chain._parent is not None:
            chain = chain._parent
        assert chain is root
    self_ns = sum(s.ns - s._child_ns for s in spans)
    assert abs(self_ns - root.ns) <= 0.01 * root.ns
    # each range on the client's thread, inside its query's range
    names = {s.name for s in spans}
    evs = prof.profiler.kineto_results.events()
    (client,) = [e.start_thread_id() for e in evs if e.name() == "client"]
    (q,) = [e for e in evs if e.name() == "query"]
    ranges = [e for e in evs if e.name() in names]
    assert len(ranges) == len(spans)
    for e in ranges:
        assert e.start_thread_id() == client
        assert q.start_ns() <= e.start_ns() <= e.end_ns() <= q.end_ns()
    totals = TRACER.totals()
    assert totals["query"]["count"] == 1
    assert abs(sum(t["self_ns"] for t in totals.values()) - root.ns) \
        <= 0.01 * root.ns


def test_pool_jobs_carry_the_query(monkeypatch):
    """A job of the worker pool runs in a copy of the submitting context:
    its span has the query's id and parent, on another thread, and is not
    taken from the parent's self time."""
    spans = []
    record = tracing.Tracer._record
    monkeypatch.setattr(tracing.Tracer, "_record",
                        lambda self, s: (spans.append(s), record(self, s)))

    def job(i):
        with TRACER.span("storage.leaf"):
            return threading.get_ident()
    with all_threads():
        root = TRACER.start_query(7)
        threads = map_shards(job, [0, 1, 2, 3])
        root.finish()
    jobs = [s for s in spans if s.name == "storage.leaf"]
    assert len(jobs) == 4
    assert all(s.qid == 7 and s._parent is root for s in jobs)
    assert threading.get_ident() not in threads
    assert root._child_ns == 0
    assert TRACER.totals()["query"]["self_ns"] == root.ns


@pytest.mark.parametrize("write", ["Set(9, f=1)", "Clear(2, f=1)",
                                   "Set(9, f=2)"])
def test_upload_once_then_cached(port, write):
    def uploads(pql):
        before = TRACER.totals().get("storage.upload", {}).get("count", 0)
        port.query("i", pql)
        return TRACER.totals().get("storage.upload", {}).get("count", 0) \
            - before
    with all_threads():
        assert uploads("Count(Row(f=1))") == 1
        assert uploads("Count(Row(f=1))") == 0
        port.query("i", write)
        assert uploads("Count(Row(f=1))") == 1
        assert uploads("Count(Row(f=1))") == 0
    leaf = TRACER.totals()["storage.leaf"]
    assert leaf["count"] == 4


@pytest.mark.parametrize("pql", ["GroupBy(Rows(f), Rows(g))",
                                 "GroupBy(Rows(f), aggregate=Sum(field=v))"])
def test_mirror_uploads_are_no_leaf_misses(port, pql):
    """GroupBy's one-launch path reads the fragments' mirrors: their
    uploads are storage.mirror_upload, once, and never storage.upload."""
    # two masks of one shard fit, of every shard not: the stacked path
    # refuses, the one-launch path takes it
    port.executor.GROUPBY_ONESHOT_MAX_MASK_BYTES = 2 * WORDS_PER_ROW * 4
    with all_threads():
        want = repr(port.query("i", pql))
        first = TRACER.totals()
        assert repr(port.query("i", pql)) == want
    again = TRACER.totals()
    assert first["storage.mirror_upload"]["count"] > 0
    assert again["storage.mirror_upload"] == first["storage.mirror_upload"]
    assert "storage.upload" not in again
    assert "kernel.pair_counts" in again or "kernel.bsi_sum_groups" in again


@pytest.mark.parametrize("pql,status", [
    ("Count(Row(f=1))", None),
    ("Options(Count(Row(f=1)), profile=true)", None),
    ("Count(Row(f=1)", 400),
])
def test_one_measurement(port, monkeypatch, pql, status):
    roots, seen = [], []
    start_query = TRACER.start_query
    monkeypatch.setattr(TRACER, "start_query",
                        lambda *a, **k: roots.append(start_query(*a, **k))
                        or roots[-1])
    observe = REGISTRY.observe
    monkeypatch.setattr(REGISTRY, "observe", lambda name, v, **labels: (
        seen.append((name, v, labels)), observe(name, v, **labels)))
    if status is None:
        port.query("i", pql)
    else:
        with pytest.raises(APIError) as e:
            port.query("i", pql)
        assert e.value.status == status
    (root,) = roots
    assert root.ns > 0
    assert [s for s in seen if s[0] == "query_seconds"] == [
        ("query_seconds", root.duration, {"index": "i"})]
    past = port.tracker.past()[0]
    assert past["runtime"] == root.duration
    assert past["PQL"] == pql
