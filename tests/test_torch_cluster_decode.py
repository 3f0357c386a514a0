"""The port's cluster against the JAX package's cluster and the port's
single node (as tests/test_torch_cluster_parity.py) on the other families:
Distinct, Percentile (the coordinator's bisection), Sort (with and without
a limit, and the unlimited Sort's pages, here of 500 records), Extract,
Limit, Var and Corr, IncludesColumn and FieldValue, Apply and Arrow, and
the keyed index.  Where the JAX cluster does not answer as one node does,
test_jax_cluster_faults pins its answers.
"""
import pytest
import torch

import torch_cluster_data as D
from featurebase_tpu_torch.cluster.distributed import DistributedExecutor
from featurebase_tpu_torch.server.serialize import response_to_json

QUERIES = D.decode_and_keyed_queries(D.table())


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    with D.world() as w:
        yield w


@pytest.fixture()
def small_pages(monkeypatch):
    monkeypatch.setattr(DistributedExecutor, "SORT_STREAM_CHUNK", 500)


@pytest.mark.parametrize("idx,q", QUERIES, ids=[q for _, q in QUERIES])
def test_family(world, small_pages, idx, q):
    D.check(world, idx, q)


def test_jax_cluster_faults(world):
    """The JAX cluster's own answers where it differs from one node (so
    the list in torch_cluster_data stays true): Var fails to encode a
    float, a Limit keeps a window a node, Apply's values come in another
    order."""
    jc, single = world["jax"], world["single"]
    got = D.answer(jc, 0, "i", "Var(field=v)")
    assert got["status"] == 500 and "cannot encode result type" in \
        got["error"]
    q = "Extract(Limit(Row(f=1), limit=20), Rows(f), Rows(v))"
    assert len(D.answer(jc, 0, "i", q)["results"][0]["columns"]) > 20
    assert len(single.query("i", q)[0].columns) == 20
    q = 'Apply(Row(f=1), "v + u")'
    j = D.answer(jc, 0, "i", q)["results"][0]
    want = response_to_json(single.query("i", q))["results"][0]
    assert sorted(j) == sorted(want) and j != want
