"""The port's cluster through a join and a backup and restore, each
followed by a query of every family (torch_cluster_data.EVENT_QUERIES)
through two nodes, against the port's single node and the JAX package's
cluster after the same event:

1. join: a fourth node admitted, the shards it now owns pulled from their
   previous owners (rebalance);
2. backup and restore through the CLI (`backup --host`, `restore --host`)
   into a fresh cluster.

And two restarts: the WAL replay must not send its imports again, and
a forwarded roaring import replays as the single node's.
"""
import pytest
import torch

import torch_cluster_data as D
from featurebase_tpu.cli import main as jax_cli
from featurebase_tpu.testing import TestCluster as JaxCluster
from featurebase_tpu_torch.cli import main as port_cli
from featurebase_tpu_torch.core.consts import SHARD_WIDTH
from featurebase_tpu_torch.testing import TestCluster

# the dataframes are not part of a backup, nor pulled by a joining node
# (in either package), so Arrow is asked before the events only
QUERIES = D.EVENT_QUERIES


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with D.world() as w:
        w["base"] = tmp_path_factory.mktemp("rebalance")
        yield w


def check_all(w, nodes, jax_keyed: bool = True):
    for idx, q in QUERIES:
        D.check(w, idx, q, nodes=nodes, jax=jax_keyed or idx != "k")


def test_join(world):
    for tc in (world["port"], world["jax"]):
        tc.add_node()
    assert len(world["port"][0].cluster.snapshot.nodes) == 4
    owned = [s for s in range(D.SHARDS)
             if world["port"][3].cluster.snapshot.owns_shard("node3", "i",
                                                             s)]
    assert owned and set(owned) <= set(
        world["port"][3].holder.index("i").available_shards())
    check_all(world, (3, 0))


def test_backup_and_restore(world):
    base = world["base"]
    tar, jtar = str(base / "port.tgz"), str(base / "jax.tgz")
    assert port_cli(["backup", "--host", world["port"].url(0),
                     "--output", tar]) == 0
    assert jax_cli(["backup", "--host", world["jax"].url(0),
                    "--output", jtar]) == 0
    pc, jc = TestCluster(3, replicas=2, device="cpu"), JaxCluster(3,
                                                                 replicas=2)
    world["clusters"] += [pc, jc]
    world["port"], world["jax"] = pc, jc
    assert port_cli(["restore", "--host", pc.url(0), "--source", tar]) == 0
    assert jax_cli(["restore", "--host", jc.url(0), "--source", jtar]) == 0
    # the JAX package's restore gives the keys to node 0 alone, so its
    # other nodes find no key of the keyed index
    check_all(world, (0, 1), jax_keyed=False)
    assert D.answer(jc, 1, "k", 'Count(Row(kf="red"))') == \
        {"results": [0]}


def test_replay_does_not_resend_imports(tmp_path):
    """A node restarted over its data directory replays its imports without
    sending them to the other owners again: a row cleared on every replica
    while the node was down stays cleared everywhere (the JAX package's
    replay sends them, and the cleared bits come back on the owners it
    shares shards with)."""
    dirs = [str(tmp_path / f"n{i}") for i in range(3)]
    cols = [s * SHARD_WIDTH + 7 for s in range(6)]
    with TestCluster(3, replicas=2, data_dirs=dirs, device="cpu") as tc:
        tc.http(0, "POST", "/index/i", {"options": {}})
        tc.http(0, "POST", "/index/i/field/f", {"options": {"type": "set"}})
        tc.http(0, "POST", "/index/i/field/f/import",
                {"rowIDs": [4] * 6, "columnIDs": cols})
        tc.stop_node(2)
        assert tc.query(0, "i", "ClearRow(f=4)") == {"results": [True]}
        tc.restart_node(2, data_dir=dirs[2])
        for n in range(3):
            assert tc.query(n, "i", "Count(Row(f=4))") == {"results": [0]}
            assert tc[n].executor.execute("i", "Count(Row(f=4))") == [0]


def test_forwarded_roaring_replays_as_acknowledged(tmp_path):
    """A roaring shard import sent to node 0 reaches every owner, and each
    owner logs it as the single node does ("replace" and the resolved
    view name): a replace of v's BSI group's rows answers as on one node,
    and so does node 1 restarted over its data directory."""
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.server.serialize import response_to_json

    def fresh(api):
        api.create_index("i")
        api.create_field("i", "v", {"type": "int", "min": 0, "max": 1000})
    src, one = API(device="cpu"), API(device="cpu")
    fresh(src)
    src.import_values("i", "v", [1, 2, 3], [10, 20, 30])
    data = src.export_roaring("i", "v", 0, view="bsig_v")
    views = {"v/bsig": {"data": data, "replace": True}}
    fresh(one)
    one.import_values("i", "v", [1, 4], [999, 7])
    one.import_roaring_shard("i", 0, views)
    want = response_to_json(one.query("i", "Sum(field=v)"))
    dirs = [str(tmp_path / f"n{i}") for i in range(2)]
    with TestCluster(2, replicas=2, data_dirs=dirs, device="cpu") as tc:
        tc.http(0, "POST", "/index/i", {"options": {}})
        tc.http(0, "POST", "/index/i/field/v",
                {"options": {"type": "int", "min": 0, "max": 1000}})
        tc.http(0, "POST", "/index/i/field/v/import",
                {"columnIDs": [1, 4], "values": [999, 7]})
        tc[0].import_roaring_shard("i", 0, views)
        assert tc.query(1, "i", "Sum(field=v)") == want
        tc.stop_node(1)
        tc.restart_node(1, data_dir=dirs[1])
        tc.stop_node(0)
        assert tc.query(1, "i", "Sum(field=v)") == want
