"""A mesh over processes in both packages on the same queries
(tests/multihost_parity_worker.py: the multihost workers' table, 2
processes x 4 CPU members, owner-placed): a bitmap result, Row(f=1),
answers alike in both and on both processes (each process gathers every
process's blocks), equal to numpy; Extract refuses in both, a RuntimeError
(its values need the other processes' blocks); Count answers alike."""
import json
import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240   # a rank's own limit: a hung rendezvous fails the test


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run(pkg: str) -> list:
    """Each rank's {query: {"answer": ...} or {"error": type}}, numpy's
    Row(f=1) among them."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests",
                                      "multihost_parity_worker.py"),
         pkg, str(port), str(pid)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{pkg} rank {pid}:\n{out[-4000:]}"
        got = {}
        for line in out.splitlines():
            if line.startswith("ANSWER "):
                d = json.loads(line[len("ANSWER "):])
                got[d.pop("query")] = d
        ranks.append(got)
    return ranks


@pytest.fixture(scope="module")
def answers():
    return {pkg: run(pkg) for pkg in ("jax", "port")}


def test_bitmap_result_gathers_every_process(answers):
    want = answers["port"][0]["numpy Row(f=1)"]["answer"]
    for pkg, ranks in answers.items():
        for got in ranks:
            row = got["Row(f=1)"]
            assert row == {"answer": {"results": [
                {"columns": want}]}}, (pkg, str(row)[:200])


def test_extract_refuses_in_both(answers):
    q = "Extract(Row(g=2), Rows(f), Rows(v))"
    for pkg, ranks in answers.items():
        for got in ranks:
            assert got[q] == {"error": "RuntimeError"}, pkg


def test_count_answers_alike(answers):
    got = {json.dumps(r["Count(Row(f=1))"])
           for ranks in answers.values() for r in ranks}
    assert len(got) == 1, got
