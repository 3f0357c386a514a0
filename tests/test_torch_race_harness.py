"""tests/test_race_harness.py's 4 tests on the port's Executor on the CPU
(the JAX test bodies with featurebase_tpu_torch's Holder, FieldOptions and
Executor(device="cpu")): racing writers and readers with no torn read,
reads of one field while another takes writes, long Extracts beside writes
to the same field with no freeze and no stalled write, and concurrent bulk
imports equal to a serial one."""
import pytest
import torch

from torch_twins import twin_namespace

globals().update(twin_namespace("test_race_harness", subs=[
    ("Executor(holder)", 'Executor(holder, device="cpu")')]))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
