"""tests/test_fbsql.py on the port: the port's fbsql shell, its table
rendering, statement splitting and meta commands, bearer auth, and the
auth-token, keygen and generate-config commands of the port's cli, and
its \\ingest through the port's Kafka source (TestIngestMeta), against
twins (tests/torch_twins.py), every request answered by both packages'
servers and compared."""
import pytest
import torch

from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_fbsql"))


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
