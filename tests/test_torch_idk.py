"""tests/test_idk.py on the port: the port's IDK (ingest/idk.py: the
generator, file-tail and SQL sources, the recordizer, the Ingester with its
checkpoint-before-commit order, auto ids across a crash) against twins
(tests/torch_twins.py: each API call the port's Ingester makes answered by
the JAX package's API and the port's API(device="cpu"), the answers
compared); and both packages' Ingesters over the same source, each into
its own API."""
import numpy as np
import pytest
import torch

from featurebase_tpu.ingest import idk as jidk
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu_torch.ingest import idk as tidk
from featurebase_tpu_torch.server.api import API as PortAPI
from test_torch_api import canon
from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_idk"))


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


QUERIES = ["Count(All())", "Sum(field=value)", "Min(field=value)",
           "Max(field=value)", "TopN(segment)", "Count(Row(segment=2))",
           "Row(value > 990)"]


def both_apis(tmp_path=None):
    out = []
    for pkg, make in (("jax", lambda d: JaxAPI(data_dir=d)),
                      ("port", lambda d: PortAPI(device="cpu",
                                                 data_dir=d))):
        d = str(tmp_path / pkg) if tmp_path is not None else None
        api = make(d)
        api.create_index("i")
        api.create_field("i", "segment", {"type": "set"})
        api.create_field("i", "value", {"type": "int", "min": -100,
                                        "max": 1000})
        out.append(api)
    return out


@pytest.mark.parametrize("auto_id", [False, True])
def test_both_ingesters_agree_across_a_crash(tmp_path, auto_id):
    """Each package's Ingester drains the same generator into its own
    durable API, crashing after the third batch's import and before its
    commit, then resuming from the committed checkpoint: every record
    lands once, and the answers are equal."""
    apis = both_apis(tmp_path)
    answers = []
    for mod, api in zip((jidk, tidk), apis):
        src = mod.GeneratorSource(total=20_000, seed=4)
        ing = mod.Ingester(api, "i", src, batch_size=4096,
                           id_field=None if auto_id else "id")

        class Crash(Exception):
            pass

        def boom(batch_no):
            if batch_no == 2:
                raise Crash()
        ing._post_import_hook = boom
        with pytest.raises(Crash):
            ing.run()
        src2 = mod.GeneratorSource(total=20_000, seed=4)
        src2._cursor = src2._committed = src.checkpoint()
        ing2 = mod.Ingester(api, "i", src2, batch_size=4096,
                            id_field=None if auto_id else "id")
        ing2.session = ing.session
        stats = ing2.run()
        assert stats["records"] == 20_000 - src.checkpoint()
        assert api.query("i", "Count(All())") == [20_000]
        answers.append([canon(api.query("i", q)) for q in QUERIES])
    assert answers[0] == answers[1]
