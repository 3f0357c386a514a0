"""tests/test_observability.py's 28 tests on twins (tests/torch_twins.py):
tracing and profiles, the query tracker, transactions, metrics, bearer
auth, /debug/pprof, the error monitor and diagnostics, and the console's
tabs, each request answered by the JAX package's server and the port's
(API(device="cpu")) and compared, the JAX test's asserts run on the port's
answers.  The module-level tracker, transaction, monitor and diagnostics
classes are the port's."""
import pytest
import torch

from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_observability"))


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
