"""The port's cluster through failover and a restart, each followed by a
query of every family (torch_cluster_data.EVENT_QUERIES) through two
nodes, against the port's single node and the JAX package's cluster after
the same event:

1. failover: node 2 stopped, the reads served by the surviving replicas
   (a Percentile's bisection included);
2. restart: writes while node 2 is down, then node 2 restarted over its
   data directory (its WAL replayed), synced from its peers and resynced.

test_torch_cluster_rebalance.py goes on with a join and a backup and
restore.
"""
import pytest
import torch

import torch_cluster_data as D
from featurebase_tpu_torch.core.consts import SHARD_WIDTH
from featurebase_tpu_torch.server.serialize import response_to_json

QUERIES = D.EVENT_QUERIES
# writes while node 2 is down: Sets, which both packages send to every
# live replica and which the JAX package's replay (it sends node 2's old
# imports to their owners again) leaves standing;
# test_replay_does_not_resend_imports holds a clear across a restart
DOWN_WRITES = [("i", f"Set({4 * SHARD_WIDTH + 99}, f=1)"),
               ("i", f"Set({2 * SHARD_WIDTH + 5}, v=777)"),
               ("k", 'Set("k2", kf="red")')]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    base = tmp_path_factory.mktemp("cluster")
    dirs = [str(base / f"port{i}") for i in range(3)]
    jdirs = [str(base / f"jax{i}") for i in range(3)]
    with D.world(data_dirs=dirs, jax_data_dirs=jdirs) as w:
        w["dirs"], w["jdirs"] = dirs, jdirs
        yield w


def check_all(w, nodes, jax_keyed: bool = True):
    for idx, q in QUERIES:
        D.check(w, idx, q, nodes=nodes, jax=jax_keyed or idx != "k")


def test_failover(world):
    for tc in (world["port"], world["jax"]):
        tc.stop_node(2)
    check_all(world, (0, 1))
    D.check(world, "i", "Percentile(field=v, nth=50)", nodes=(0, 1))


def test_restart_and_resync(world):
    for idx, q in DOWN_WRITES:
        want = response_to_json(world["single"].query(idx, q))
        assert world["port"].query(0, idx, q) == want, q
        assert world["jax"].query(0, idx, q) == want, q
    world["port"].restart_node(2, data_dir=world["dirs"][2])
    world["jax"].restart_node(2, data_dir=world["jdirs"][2])
    check_all(world, (2, 0))
    # node 2's own holder holds the writes it missed, for its shards
    api2 = world["port"][2]
    for idx, q in DOWN_WRITES[:2]:
        col = int(q[4:q.index(",")])
        s = col // SHARD_WIDTH
        if api2.cluster.snapshot.owns_shard("node2", idx, s):
            assert api2.shard_fragment_checksums(idx, s)["fragments"] == \
                world["port"][0].shard_fragment_checksums(idx, s)[
                    "fragments"]
