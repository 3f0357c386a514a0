"""tests/test_fuzz_differential.py through the port: its 12 seeds of
random data and its whole battery (set algebra, counts, BSI ranges,
aggregates, TopN, Distinct, GroupBy, Sort, Extract, the Percentile
bisection on both of its paths), every query answered by the port's
Executor(device="cpu") and the JAX executor over the same data: the two
answers must be equal, and the JAX test's own numpy asserts run on the
port's answer."""
import functools
import os

import pytest
import torch

from featurebase_tpu_torch.executor.executor import Executor as PortExecutor
from test_torch_api import canon
from torch_twins import TESTS, twin_namespace

_src = os.path.join(TESTS, "test_fuzz_differential.py")
_jax: dict = {"__name__": "jax_fuzz", "__file__": _src}
with open(_src) as _fh:
    exec(compile(_fh.read(), _src, "exec"), _jax)

_port = twin_namespace(
    "test_fuzz_differential",
    subs=[("e = Executor(holder)", 'e = Executor(holder, device="cpu")')])


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Both(PortExecutor):
    """The port's Executor over one seed's holder, with the JAX executor
    over the same seed's: execute runs both and compares."""

    def __init__(self, port_executor, jax_executor):
        super().__init__(port_executor.holder, device="cpu")
        self.jax = jax_executor

    def execute(self, index, query, *args, **kw):
        want = self.jax.execute(index, query, *args, **kw)
        got = super().execute(index, query, *args, **kw)
        assert canon(got) == canon(want), (query, canon(got), canon(want))
        return got


@functools.lru_cache(maxsize=4)
def _pair(seed: int):
    (pe, d), (je, _) = _port["dataset"](seed), _jax["dataset"](seed)
    return pe, je, d


def dataset(seed: int):
    pe, je, d = _pair(seed)
    return Both(pe, je), d


TestDifferential = _port["TestDifferential"]
TestPercentileDifferential = _port["TestPercentileDifferential"]
# the test bodies read `dataset` from their module's globals
TestDifferential.test_counts.__globals__["dataset"] = dataset
