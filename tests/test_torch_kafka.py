"""tests/test_kafka.py on the port (ingest/kafka_wire.py, kafka_broker.py,
kafka_source.py, schema_registry.py: the legacy and flexible codecs, the
in-process broker with persisted offsets, consumer groups, Avro, SASL
PLAIN, the registry, and produce -> ingest -> crash -> resume) against
twins (tests/torch_twins.py); the wire across the packages (each
package's client against the other's broker); and both packages'
Ingesters reading one topic under their own consumer groups, each into
its own API."""
import json

import numpy as np
import pytest
import torch

from featurebase_tpu.ingest import idk as jidk
from featurebase_tpu.ingest import kafka_broker as jbroker
from featurebase_tpu.ingest import kafka_source as jsource
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu_torch.ingest import datagen as tdg
from featurebase_tpu_torch.ingest import idk as tidk
from featurebase_tpu_torch.ingest import kafka_broker as tbroker
from featurebase_tpu_torch.ingest import kafka_source as tsource
from featurebase_tpu_torch.server.api import API as PortAPI
from test_torch_api import canon
from torch_twins import assert_no_mismatch, twin_namespace

globals().update(twin_namespace("test_kafka"))


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


@pytest.mark.parametrize("client_pkg,broker_pkg",
                         [(jsource, tbroker), (tsource, jbroker)])
@pytest.mark.parametrize("flexible", [False, True])
def test_wire_across_the_packages(client_pkg, broker_pkg, flexible):
    """One package's client produces, fetches and commits offsets against
    the other's broker, on the legacy and the flexible versions."""
    b = broker_pkg.KafkaBroker(num_partitions=2).start()
    try:
        c = client_pkg.KafkaClient("127.0.0.1", b.port)
        if flexible:
            c.negotiate()
        c.metadata(["t"])
        msgs = [(str(i).encode(), json.dumps({"id": i}).encode())
                for i in range(30)]
        c.produce("t", 1, msgs)
        got = c.fetch("t", 1, 0, max_bytes=1 << 20)
        assert [(o, k, v) for o, k, v, _ in got] == \
            [(i, k, v) for i, (k, v) in enumerate(msgs)]
        c.offset_commit("g", {("t", 1): 17})
        assert c.offset_fetch("g", "t", [1]) == {1: 17}
        c.close()
    finally:
        b.stop()


QUERIES = ["Count(All())", "TopN(s)", "Count(Row(m=3))", "Count(Row(b=1))",
           "Sum(field=i)", "Min(field=i)", "Max(field=i)", "Sum(field=d)",
           "Max(field=d)", "Min(field=ts)", "Row(i > 990)",
           "GroupBy(Rows(m), Rows(b))"]


def test_both_ingesters_read_one_topic(tmp_path):
    """load_kafka puts 3,000 kitchen-sink records (every field type) on
    the port's broker; the JAX package's Ingester and the port's each
    consume the topic under their own group into their own durable API
    (the port's crashing once after an import and before its commit, then
    resuming): the answers are equal, and equal to load_index of the same
    records (the generator draws batch by batch, so both take batches of
500)."""
    b = tbroker.KafkaBroker(num_partitions=1).start()
    try:
        c = tsource.KafkaClient("127.0.0.1", b.port)
        c.negotiate()
        assert tdg.load_kafka(c, "ks", "kitchen-sink", 0, 2999, seed=6,
                              batch_size=500) == 3000
        c.close()
        schema = tdg.resolve_source("kitchen-sink")
        answers = []
        for pkg, mod, src_mod, make in (
                ("jax", jidk, jsource, lambda d: JaxAPI(data_dir=d)),
                ("port", tidk, tsource,
                 lambda d: PortAPI(device="cpu", data_dir=d))):
            api = make(str(tmp_path / pkg))
            tdg.ensure_schema(api, "k", schema)
            src = src_mod.KafkaSource(f"127.0.0.1:{b.port}", "ks",
                                      group=f"g-{pkg}")
            ing = mod.Ingester(api, "k", src, batch_size=700)
            if pkg == "port":
                def crash(batch_no):
                    if batch_no == 2:
                        raise RuntimeError("crash before the commit")
                ing._post_import_hook = crash
                with pytest.raises(RuntimeError):
                    ing.run()
                api = make(str(tmp_path / pkg))   # restart from disk
                src = src_mod.KafkaSource(f"127.0.0.1:{b.port}", "ks",
                                          group=f"g-{pkg}")
                ing = mod.Ingester(api, "k", src, batch_size=700)
            ing.run()
            assert api.query("k", "Count(All())") == [3000]
            answers.append([canon(api.query("k", q)) for q in QUERIES])
        assert answers[0] == answers[1]
        direct = PortAPI(device="cpu")
        tdg.load_index(direct, "k", "kitchen-sink", 0, 2999, seed=6,
                       batch_size=500)
        assert [canon(direct.query("k", q)) for q in QUERIES] == answers[1]
        parts = [c for _, c in tdg.generate_batches(schema, 0, 2999, seed=6,
                                                    batch_size=500)]
        cols = {k: np.concatenate([c[k] for c in parts]) for k in parts[0]}
        (vc,) = direct.query("k", "Sum(field=i)")
        assert (vc.val, vc.count) == (int(cols["i"].sum()), 3000)
        assert direct.query("k", "Count(Row(b=1))") == \
            [int((cols["b"] == 1).sum())]
    finally:
        b.stop()
