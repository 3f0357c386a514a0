"""tests/test_cluster.py on the port: placement, schema broadcast,
distributed queries, writes from any node, keys, replication and failover,
the concurrent fan-out and the unlimited Sort's pages, each through a
TestCluster of the port's nodes on the CPU (tests/torch_twins.py
port_namespace), every answer held against the port's single-node
API(device="cpu") as the JAX test holds the JAX package's; and
tests/test_sql_extended.py::TestDistributedSQL, SQL on a three-node
cluster."""
import pytest
import torch

from torch_twins import port_namespace

globals().update(port_namespace("test_cluster"))
TestDistributedSQL = port_namespace("test_sql_extended")["TestDistributedSQL"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
