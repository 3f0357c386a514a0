"""tests/test_client.py's 6 tests with the port's client
(featurebase_tpu_torch/client.py) against twins (tests/torch_twins.py):
the builders, schema and query round trips, errors, batch and keyed
imports, and failover, every request answered by both packages' servers
and compared."""
import pytest
import torch

from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_client"))


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
