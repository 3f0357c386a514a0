"""The port's mesh over two processes: 2 processes x 4 CPU members form
one 8-member "shards" mesh joined over torch.distributed's Gloo backend,
with owner-placed host masters (tests/torch_multihost_worker.py).  Each
aggregate merges across the process boundary and equals numpy; each
process holds host fragments only for the shards it owns, and its share of
the host bytes follows its share of the shards.  The counterpart of
tests/test_multihost.py."""
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120   # a rank's own limit: a hung rendezvous fails the test


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_aggregates():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(ROOT, "tests", "torch_multihost_worker.py"),
             str(port), str(pid), "--members", "4", "--device", "cpu",
             "--backend", "gloo"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bytes_by_pid, owned_by_pid = {}, {}
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"MULTIHOST_OK {pid}" in out
        for line in out.splitlines():
            if line.startswith("MULTIHOST_BYTES"):
                _, wpid, nbytes, nowned = line.split()
                bytes_by_pid[int(wpid)] = int(nbytes)
                owned_by_pid[int(wpid)] = int(nowned)
    # owner-placed host masters: each process's host bytes follow its
    # owned share of the shards
    assert set(bytes_by_pid) == {0, 1}
    total_b = sum(bytes_by_pid.values())
    total_o = sum(owned_by_pid.values())
    assert total_o == 16
    for pid in (0, 1):
        share = bytes_by_pid[pid] / total_b
        owned_share = owned_by_pid[pid] / total_o
        assert abs(share - owned_share) < 0.15, \
            (pid, share, owned_share, bytes_by_pid, owned_by_pid)
