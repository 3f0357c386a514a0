"""What the port's server surface leaves to a later item says so: every
subcommand and route below raises NotImplementedError naming its
ROADMAP.md queue 1 item (14 the cluster, 15 DAX), and a route answers it
as every other internal error, a 500 carrying the message
(featurebase_tpu_torch/server/http_server.py)."""
import json
import urllib.error
import urllib.request

import pytest
import torch

from featurebase_tpu_torch import cli
from featurebase_tpu_torch.server.api import API
from featurebase_tpu_torch.server.http_server import Server


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def message(item: int) -> str:
    return f"(ROADMAP.md queue 1 item {item})"


CLI = [
    (15, ["dax"]),
    (14, ["backup", "-o", "out.tar"]),
    (14, ["backuptar", "-o", "out.tar"]),
    (14, ["restore", "--source", "in.tar"]),
    (14, ["restoretar", "--source", "in.tar"]),
    (14, ["server", "--cpu", "--cluster-nodes", "a=http://127.0.0.1:1"]),
]

ROUTES = [
    (14, "POST", "/internal/resync", None),
    (14, "POST", "/internal/cluster/message", {"type": "x"}),
    (14, "POST", "/internal/cluster/join", {"id": "n2"}),
    (14, "POST", "/internal/cluster/leave", {"id": "n2"}),
    (14, "GET", "/internal/schema/log?from=0", None),
    (14, "GET", "/internal/translate/snapshot", None),
    (14, "POST", "/internal/translate/restore", {"snap": {}}),
    (14, "GET", "/internal/translate/checksums", None),
    (14, "POST", "/internal/translate/index/i/replicate", {"entries": {}}),
    (14, "POST", "/internal/translate/field/i/f/replicate", {"entries": {}}),
    (14, "GET", "/internal/index/i/shard/0/snapshot", None),
    (14, "GET", "/internal/index/i/shard/0/fragment?field=f&view=standard",
     None),
    (14, "POST", "/internal/restore/i/0", {}),
    (14, "POST", "/index/i/query", {"remote": True, "ast": [],
                                    "shards": [0]}),
]

CASES = ([pytest.param("cli", item, argv, id="cli-" + argv[0] + (
    "-cluster-nodes" if "--cluster-nodes" in argv else ""))
    for item, argv in CLI]
    + [pytest.param("route", item, (m, p, b), id=f"{m}-{p}")
       for item, m, p, b in ROUTES])


@pytest.fixture(scope="module")
def server():
    api = API(device="cpu")
    api.create_index("i")
    api.create_field("i", "f", {"type": "set"})
    api.query("i", "Set(1, f=1)")
    srv = Server(api=api).start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("kind,item,what", CASES)
def test_waits_for_its_item(kind, item, what, server, tmp_path, monkeypatch):
    if kind == "cli":
        monkeypatch.chdir(tmp_path)
        with pytest.raises(NotImplementedError, match=message(item).replace(
                "(", r"\(").replace(")", r"\)")):
            cli.main(what)
    else:
        method, path, body = what
        req = urllib.request.Request(
            server.url + path, method=method,
            data=json.dumps(body).encode() if body is not None else None)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 500
        err = json.loads(ei.value.read())["error"]
        assert err.startswith("internal error: ") and message(item) in err
