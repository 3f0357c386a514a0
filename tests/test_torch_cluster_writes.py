"""The writes through the clusters (tests/torch_cluster_data.py): each of
Set, Clear, ClearRow, Store and Delete, on the unkeyed index and with keys
on the keyed one, sent to the port's cluster through node 1 and to the JAX
package's through node 0, answers as the port's single node does; then
every read (the writes' own and a query of every family) answers alike
through both port nodes and the JAX cluster.
"""
import pytest
import torch

import torch_cluster_data as D
from featurebase_tpu_torch.server.serialize import response_to_json

T = D.table()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    with D.world() as w:
        for idx, q in D.writes(T):
            want = response_to_json(w["single"].query(idx, q))
            w.setdefault("writes", []).append(
                (q, want, w["port"].query(1, idx, q),
                 w["jax"].query(0, idx, q)))
        yield w


def test_write_answers(world):
    for q, want, port, jax in world["writes"]:
        assert port == want, q
        assert jax == want, q


# the writes' own reads, a query of every family, and the families
# EVENT_QUERIES leaves out
READS = D.WRITE_READS + D.EVENT_QUERIES + [
    ("i", "Percentile(field=v, nth=50)"), ("i", "Arrow(Row(g=2))"),
    ("i", "Limit(Row(f=1), limit=5, offset=2)"),
    ("i", 'Apply(Row(f=1), "v + u")'), ("k", "Distinct(field=kf)")]


@pytest.mark.parametrize("idx,q", READS, ids=[q for _, q in READS])
def test_read_after_writes(world, idx, q):
    D.check(world, idx, q)


def test_replicas_agree_after_writes(world):
    """Store, ClearRow and Delete reach every live replica of each shard in
    the port's cluster, so the two owners of every shard hold the same
    fragments; the JAX package's cluster applies them on the first live
    owner alone, and its replicas differ."""
    def diverged(tc, idx):
        out = []
        for s in tc[0].holder.index(idx).available_shards() + \
                tc[1].holder.index(idx).available_shards():
            owners = tc[0].cluster.snapshot.shard_nodes(idx, s)
            sums = [tc[int(n.id[4:])].shard_fragment_checksums(idx, s)
                    ["fragments"] for n in owners]
            if sums[0] != sums[1]:
                out.append(s)
        return out
    for idx in ("i", "k"):
        assert diverged(world["port"], idx) == []
    assert diverged(world["jax"], "i")
