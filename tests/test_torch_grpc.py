"""tests/test_grpc.py's 8 tests on twins (tests/torch_twins.py): QueryPQL
and QuerySQL, streamed and unary, index CRUD and Inspect, each request sent
to the JAX package's gRPC server and the port's (API(device="cpu")) and the
replies compared byte for byte, the JAX test's asserts run on the port's.
The messages are the port's (featurebase_tpu_torch/proto/pilosa_pb2.py)."""
import pytest
import torch

from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_grpc"))


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
