"""tests/test_placement.py on the port (tests/torch_twins.py
port_namespace): the placement policy, the write gate, and the handoff of
host fragments when the process count changes, in one process
(test_handoff_moves_host_fragments) and over a live TestCluster of the
port's nodes (TestLiveReconfigure)."""
import pytest
import torch

from torch_twins import port_namespace

globals().update(port_namespace("test_placement", subs=[
    ("Executor(tc[i].holder)", 'Executor(tc[i].holder, device="cpu")')]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
