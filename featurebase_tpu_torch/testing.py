"""In-process multi-node cluster harness.

Own copy of featurebase_tpu/testing.py.  Mirrors the reference's
test.MustRunCluster (reference: test/cluster.go:748
MustRunCluster boots n real Servers with embedded etcd on ephemeral ports in
one process).  Here each node is a real ThreadingHTTPServer + API + Cluster
on an ephemeral loopback port; inter-node traffic is real HTTP, so the
distributed executor, broadcast, replication, and failover paths are all
exercised for real.

`device` goes to every node's API: None is CUDA (and raises without it),
"cpu" the plain PyTorch path.  The nodes of one process share one card and
the process-wide residency budget (storage/residency.py).
"""
from __future__ import annotations

import json
import socket
import urllib.request
from typing import List, Optional

from featurebase_tpu_torch.cluster.cluster import Cluster
from featurebase_tpu_torch.server.api import API
from featurebase_tpu_torch.server.http_server import Server


class TestCluster:
    """n in-process nodes; index [i] for each node's API, .url(i) for HTTP."""

    __test__ = False  # not a pytest case despite the name

    def __init__(self, n: int, replicas: int = 1,
                 data_dirs: Optional[List[str]] = None, device=None):
        self.device = device
        self._held = {}   # node -> its port, bound and not listening
        self.servers: List[Server] = [Server(defer_api=True)
                                      for _ in range(n)]
        node_list = [{"id": f"node{i}", "uri": s.url}
                     for i, s in enumerate(self.servers)]
        self.apis: List[API] = []
        for i, srv in enumerate(self.servers):
            cluster = Cluster(f"node{i}",
                              [dict(nd) for nd in node_list],
                              replicas=replicas)
            api = API(cluster=cluster,
                      data_dir=data_dirs[i] if data_dirs else None,
                      device=device)
            srv.set_api(api)
            srv.start()
            self.apis.append(api)

    def __getitem__(self, i: int) -> API:
        return self.apis[i]

    def __len__(self):
        return len(self.apis)

    def url(self, i: int) -> str:
        return self.servers[i].url

    def stop_node(self, i: int):
        """Simulate a node failure (reference: pumba/docker-pause fault
        injection, internal/clustertests pause_node_test.go:46).  Its port
        stays bound, without a listener, until restart_node: peers' calls
        are refused as by a dead node, and no other server of the machine
        takes the port meanwhile."""
        self.servers[i].stop()
        hold = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        hold.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            hold.bind(("127.0.0.1", self.servers[i].port))
            self._held[i] = hold
        except OSError:   # taken already: restart_node will say so
            hold.close()

    def restart_node(self, i: int, data_dir: Optional[str] = None):
        """Bring a stopped node back on the SAME port with a fresh (or
        durably-restored) API, pull schema/translate from peers, and run the
        shard anti-entropy pass (reference: node restart -> holder.Open +
        holderSyncer resync, holder.go:432,1303)."""
        old = self.servers[i]
        hold = self._held.pop(i, None)
        if hold is not None:
            hold.close()
        srv = Server(defer_api=True, port=old.port)
        node_list = [{"id": f"node{j}", "uri": s.url if j != i else srv.url}
                     for j, s in enumerate(self.servers)]
        cluster = Cluster(f"node{i}", node_list,
                          replicas=self.apis[i].cluster.snapshot.replicas)
        api = API(cluster=cluster, data_dir=data_dir, device=self.device)
        srv.set_api(api)
        srv.start()
        self.servers[i] = srv
        self.apis[i] = api
        cluster.sync_from_peers(api, retries=3)
        api.resync_shards()
        # let peers notice it is back
        for j, a in enumerate(self.apis):
            if j != i and a.cluster is not None:
                a.cluster.mark_up(f"node{i}")
        return api

    def add_node(self) -> API:
        """Dynamically join a new node to the running cluster (reference
        analog: DAX RegisterWorker; monolith reference has no resize).  The
        joiner boots with the current topology plus itself, announces via
        POST /internal/cluster/join on node 0 (which broadcasts the new
        topology), then pulls schema + owned-shard data."""
        i = len(self.servers)
        srv = Server(defer_api=True)
        node_list = [n.to_json()
                     for n in self.apis[0].cluster.snapshot.nodes]
        me = {"id": f"node{i}", "uri": srv.url}
        cluster = Cluster(f"node{i}", node_list + [dict(me)],
                          replicas=self.apis[0].cluster.snapshot.replicas)
        api = API(cluster=cluster, device=self.device)
        srv.set_api(api)
        srv.start()
        self.servers.append(srv)
        self.apis.append(api)
        self.http(0, "POST", "/internal/cluster/join", body=me)
        cluster.sync_from_peers(api, retries=3)
        from featurebase_tpu_torch.cluster.topology import (ClusterSnapshot,
                                                            Node)
        prev = ClusterSnapshot([Node.from_json(dict(n)) for n in node_list],
                               replicas=cluster.snapshot.replicas)
        api.rebalance_pull(prev)
        return api

    def close(self):
        for hold in self._held.values():
            hold.close()
        self._held.clear()
        for s in self.servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- HTTP conveniences (reference: test/cluster.go Query/QueryHTTP) -------

    def http(self, i: int, method: str, path: str, body=None,
             raw: bytes = None):
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        req = urllib.request.Request(self.url(i) + path, data=data,
                                     method=method)
        req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=30) as resp:
            payload = resp.read()
        return json.loads(payload) if payload else {}

    def query(self, i: int, index: str, pql: str):
        return self.http(i, "POST", f"/index/{index}/query",
                         raw=pql.encode())
