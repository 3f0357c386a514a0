"""The port's cluster against the JAX package's cluster and the port's
single node, over one table (tests/torch_cluster_data.py): a
TestCluster(3, replicas=2) of each package and an API(device="cpu"), each
loaded with the same numpy-seeded bits, values, keys and dataframes.

Here the bitmap calls, Count, TopN/TopK, Sum, Min/Max, MinRow/MaxRow, Rows,
UnionRows and GroupBy (test_torch_cluster_decode.py: the other families).
Every family's answer through the port's coordinator (node 0) and through
a second node (node 1) equals the single node's exactly (Var and Corr
within the moment tests' 1e-6), and the JAX cluster's through its node 0
does too, except where the JAX cluster does not answer as one node does
(torch_cluster_data.JAX_CLUSTER_DIFFERS), which
test_torch_cluster_decode.py::test_jax_cluster_faults pins.  test_torch_cluster_writes.py and test_torch_cluster_events.py go on
from here: the writes, and failover, a join, a restart with resync and a
backup and restore.
"""
import pytest
import torch

import torch_cluster_data as D

QUERIES = D.set_and_aggregate_queries(D.table())


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


@pytest.mark.parametrize("idx,q", QUERIES, ids=[q for _, q in QUERIES])
def test_family(world, idx, q):
    D.check(world, idx, q)
