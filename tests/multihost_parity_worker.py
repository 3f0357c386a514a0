"""One process of tests/test_torch_multihost_parity.py: the table of
tests/multihost_worker.py (and tests/torch_multihost_worker.py) on a mesh of
2 processes x 4 CPU members of one package, owner-placed, then each query
of QUERIES, printed as "ANSWER" and a JSON object: the query and its
serialized answer, or the error's type; then numpy's Row(f=1).

Usage: multihost_parity_worker.py jax|port PORT RANK
"""
import json
import sys

QUERIES = ["Row(f=1)", "Extract(Row(g=2), Rows(f), Rows(v))",
           "Count(Row(f=1))"]


def main():
    pkg, port, pid = sys.argv[1], sys.argv[2], int(sys.argv[3])
    import numpy as np
    if pkg == "jax":
        import os
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4")
        import jax
        jax.config.update("jax_platforms", "cpu")
        from featurebase_tpu.parallel import multihost, placement
        multihost.initialize(f"localhost:{port}", num_processes=2,
                             process_id=pid, cpu_collectives="gloo")
        mesh = multihost.global_mesh()
        from featurebase_tpu.core.consts import SHARD_WIDTH
        from featurebase_tpu.executor.executor import Executor
        from featurebase_tpu.model.field import FieldOptions
        from featurebase_tpu.model.index import Holder
        from featurebase_tpu.server.serialize import response_to_json
    else:
        import torch
        torch.set_num_threads(1)
        from featurebase_tpu_torch.parallel import multihost, placement
        multihost.initialize(f"localhost:{port}", 2, pid, "gloo")
        mesh = multihost.global_mesh(4, "cpu")
        from featurebase_tpu_torch.core.consts import SHARD_WIDTH
        from featurebase_tpu_torch.executor.executor import Executor
        from featurebase_tpu_torch.model.field import FieldOptions
        from featurebase_tpu_torch.model.index import Holder
        from featurebase_tpu_torch.server.serialize import response_to_json
    placement.configure(n_processes=2, process_id=pid)
    holder = Holder()
    idx = holder.create_index("mh")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", FieldOptions(type="int", min=-100, max=10000))
    rng = np.random.default_rng(42)  # the workers' table
    n = 5000
    cols = np.sort(rng.choice(16 * SHARD_WIDTH, size=n, replace=False))
    fr = rng.integers(0, 4, size=n)
    gr = rng.integers(0, 3, size=n)
    vv = rng.integers(-100, 10000, size=n)
    idx.field("f").import_bits(fr, cols)
    idx.field("g").import_bits(gr, cols)
    idx.field("v").import_values(cols, vv)
    idx.mark_exists(cols)
    ex = Executor(holder, mesh=mesh)
    for q in QUERIES:
        try:
            out = {"answer": response_to_json(ex.execute("mh", q))}
        except Exception as e:  # noqa: BLE001 — the error is the answer
            out = {"error": type(e).__name__}
        print("ANSWER", json.dumps({"query": q, **out}), flush=True)
    print("ANSWER", json.dumps({"query": "numpy Row(f=1)", "answer": [
        int(c) for c in cols[fr == 1]]}), flush=True)


if __name__ == "__main__":
    main()
