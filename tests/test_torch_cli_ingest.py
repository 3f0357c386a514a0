"""The port's ingest commands and routes beside the JAX package's: the
CLI's export, datagen (index and kafka targets) and consume, and the
server's roaring routes, against twin servers (tests/torch_twins.py: each
request answered by both packages' servers and compared)."""
import base64
import json
import urllib.request

import numpy as np
import pytest
import torch

from featurebase_tpu import cli as jcli
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu_torch import cli as tcli
from featurebase_tpu_torch.ingest import roaring_import as tri
from featurebase_tpu_torch.ingest.kafka_broker import KafkaBroker
from featurebase_tpu_torch.ingest.kafka_source import KafkaClient
from featurebase_tpu_torch.server.api import API as PortAPI
from test_torch_api import canon
from torch_twins import API, Server, assert_no_mismatch


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


@pytest.fixture()
def twins():
    srv = Server(api=API()).start()
    yield srv
    srv.stop()


def post(url, path, body, raw=False):
    req = urllib.request.Request(
        url + path, method="POST", data=body if raw else
        json.dumps(body).encode(),
        headers={"Content-Type": "application/octet-stream" if raw
                 else "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def rows(rng, ids):
    out = {}
    for r in ids:
        w = np.zeros(1 << 15, dtype=np.uint32)
        cols = rng.choice(1 << 20, 3000, replace=False)
        np.bitwise_or.at(w, cols >> 5,
                         np.uint32(1) << (cols & 31).astype(np.uint32))
        out[r] = w
    return out


def test_roaring_routes_and_export_command(twins, tmp_path, capsys):
    """POST .../import-roaring/{shard} (raw and JSON bodies) and
    .../shard/{s}/import-roaring, then the export command of each package
    against the twins: the same bytes."""
    rng = np.random.default_rng(2)
    post(twins.url, "/index/i", {"options": {}})
    post(twins.url, "/index/i/field/f", {"options": {"type": "set"}})
    post(twins.url, "/index/i/field/g", {"options": {"type": "set"}})
    a = tri.payload_from_rows(rows(rng, [1, 4]))
    post(twins.url, "/index/i/field/f/import-roaring/0", a, raw=True)
    post(twins.url, "/index/i/field/f/import-roaring/2",
         {"data": base64.b64encode(a).decode(), "view": "standard"})
    post(twins.url, "/index/i/shard/1/import-roaring", {"views": {
        "f": {"data": base64.b64encode(a).decode()},
        "g/standard": {"data": base64.b64encode(
            tri.payload_from_rows(rows(rng, [7]))).decode()}}})
    got = post(twins.url, "/index/i/query",
               {"query": "Count(Row(f=1)) Count(Row(g=7)) Count(All())"})
    assert json.loads(got)["results"][0] == 9000
    outs = []
    for main, name in ((jcli.main, "jax"), (tcli.main, "port")):
        path = tmp_path / f"{name}.roaring"
        for shard in (0, 1, 2):
            assert main(["export", "--host", twins.url, "--index", "i",
                         "--field", "f", "--shard", str(shard),
                         "-o", str(path) + str(shard)]) == 0
        outs.append([open(str(path) + str(s), "rb").read()
                     for s in (0, 1, 2)])
    assert outs[0] == outs[1] and outs[1][0] == a == outs[1][2]
    capsys.readouterr()


def test_datagen_command_to_index_and_kafka(twins, capsys):
    """datagen --target index through each package's CLI into the twins,
    and --target kafka onto the port's broker: the same records."""
    for main in (jcli.main, tcli.main):
        assert main(["datagen", "--source", "equipment", "--index",
                     f"eq{'j' if main is jcli.main else 'p'}", "--host",
                     twins.url, "--end-at", "1999", "--seed", "4",
                     "--batch-size", "500"]) == 0
    for q in ("Count(All())", "TopN(etype)", "Sum(field=cost)"):
        a = json.loads(post(twins.url, "/index/eqj/query", {"query": q}))
        b = json.loads(post(twins.url, "/index/eqp/query", {"query": q}))
        assert a == b
    b = KafkaBroker(num_partitions=1).start()
    try:
        got = []
        for main, topic in ((jcli.main, "tj"), (tcli.main, "tp")):
            assert main(["datagen", "--source", "customer", "--target",
                         "kafka", "--kafka-port", str(b.port), "--topic",
                         topic, "--end-at", "299"]) == 0
            c = KafkaClient("127.0.0.1", b.port)
            got.append([(k, v) for _, k, v, _ in c.fetch(topic, 0, 0)])
            c.close()
        assert len(got[0]) == 300 and got[0] == got[1]
    finally:
        b.stop()
    capsys.readouterr()


def test_consume_command_into_each_package(tmp_path, capsys):
    """consume of one topic by each package's CLI under its own group,
    into its own durable directory (the port's with --cpu): the answers
    equal."""
    b = KafkaBroker(num_partitions=2).start()
    try:
        c = KafkaClient("127.0.0.1", b.port)
        c.metadata(["ev"])
        for p in (0, 1):
            c.produce("ev", p, [(None, json.dumps(
                {"id": i, "segment": i % 5, "value": i * 3}).encode())
                for i in range(p, 4000, 2)])
        c.close()
        dirs = {}
        for name, main, extra in (("jax", jcli.main, []),
                                  ("port", tcli.main, ["--cpu"])):
            d = str(tmp_path / name)
            seed = (JaxAPI if name == "jax" else
                    lambda data_dir: PortAPI(data_dir=data_dir,
                                             device="cpu"))(data_dir=d)
            seed.create_index("k")
            seed.create_field("k", "segment", {"type": "set"})
            seed.create_field("k", "value", {"type": "int", "min": 0,
                                             "max": 20000})
            seed.checkpoint()
            del seed
            assert main(["consume", "--bootstrap", f"127.0.0.1:{b.port}",
                         "--topic", "ev", "--group", name, "--index", "k",
                         "--data-dir", d, "--batch-size", "700", *extra]) \
                == 0
            out = capsys.readouterr().out
            assert json.loads(out.strip().splitlines()[-1])["records"] == \
                4000
            dirs[name] = d
        j = JaxAPI(data_dir=dirs["jax"])
        p = PortAPI(data_dir=dirs["port"], device="cpu")
        for q in ("Count(All())", "TopN(segment)", "Sum(field=value)",
                  "Max(field=value)", "Row(value < 30)"):
            assert canon(p.query("k", q)) == canon(j.query("k", q))
    finally:
        b.stop()


def test_consume_without_cuda_wants_the_cpu_flag(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: API() takes it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["consume", "--bootstrap", "127.0.0.1:1", "--topic", "t",
                   "--index", "i", "--data-dir", str(tmp_path / "d")])
