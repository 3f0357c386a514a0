"""tests/test_resync.py on the port (tests/torch_twins.py port_namespace)."""
import pytest
import torch

from torch_twins import port_namespace

globals().update(port_namespace("test_resync"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
