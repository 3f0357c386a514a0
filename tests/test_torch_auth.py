"""tests/test_auth.py's 16 tests on the port: the token verifier, the group
authorizer and the route table are the port's (server/auth.py); the HTTP
enforcement and the gRPC TLS test run on twins (tests/torch_twins.py),
every request answered by both packages' servers and compared, POST
/internal/resync's included."""
import pytest
import torch

from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_auth"))


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
