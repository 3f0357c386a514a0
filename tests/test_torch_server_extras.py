"""tests/test_server_extras.py on the port, against twins
(tests/torch_twins.py): atomic-record imports, TLS, the web console, the
writes cap, the internal info routes and mutex-check, and the presort and
wal-info commands of the port's cli; TestRecalculateCaches on a two-node
TestCluster of the port's nodes on the CPU."""
import pytest
import torch

from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_server_extras", subs=[
    ("TestCluster(2)", 'TestCluster(2, device="cpu")')]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def packages_agree():
    assert_no_mismatch()
    yield
    assert_no_mismatch()
