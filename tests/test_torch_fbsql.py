"""tests/test_fbsql.py on the port: the port's fbsql shell, its table
rendering, statement splitting and meta commands, bearer auth, and the
auth-token, keygen and generate-config commands of the port's cli, against
twins (tests/torch_twins.py), every request answered by both packages'
servers and compared.  8 of its 9 tests: TestIngestMeta (a Kafka source)
waits for ROADMAP.md queue 1 item 13, and test_torch_server_limits.py pins
its NotImplementedError."""
import pytest
import torch

from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_fbsql", drop=["TestIngestMeta"]))


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
