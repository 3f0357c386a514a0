"""The data, queries and comparisons of the cluster parity tests
(tests/test_torch_cluster_*.py).

One table, made from a seed with numpy, loads into the JAX package's
TestCluster, the port's TestCluster(device="cpu") and the port's single
node (an API(device="cpu") over the same imports): an unkeyed index "i"
(set fields f and g, int fields v and u, a dataframe a shard) and a keyed
index "k" (record keys, a keyed set field kf, an int field n).
"""
from __future__ import annotations

import json
import urllib.error
from contextlib import contextmanager

import numpy as np

from featurebase_tpu_torch.core.consts import SHARD_WIDTH

SHARDS = 7
RECORDS = 1500          # a shard of "i"
# records of "k": a column key takes an id in a shard whose partition is
# the key's, so 16 keys spread over up to 16 shards of the hundreds the
# partitions reach
KEYED_RECORDS = 16
COLORS = ["red", "blue", "green", "teal"]


def table(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    cols = np.concatenate([
        np.sort(rng.choice(SHARD_WIDTH, RECORDS, replace=False))
        + s * SHARD_WIDTH for s in range(SHARDS)])
    v = rng.integers(-1000, 10000, cols.size)
    return {"cols": cols,
            "f": rng.integers(0, 6, cols.size),
            "g": rng.integers(0, 4, cols.size),
            "v": v,
            "u": v // 3 + rng.integers(-50, 50, cols.size),
            "keys": [f"k{i}" for i in range(KEYED_RECORDS)],
            "kf": [COLORS[i] for i in rng.integers(0, 4, KEYED_RECORDS)],
            "n": rng.integers(0, 500, KEYED_RECORDS)}


def load(http, t: dict) -> None:
    """Create and fill both indexes through `http(method, path, body)`:
    a node's HTTP (imports route to the shards' owners) or LocalHTTP."""
    http("POST", "/index/i", {"options": {"trackExistence": True}})
    for name, opts in (("f", {"type": "set"}), ("g", {"type": "set"}),
                       ("v", {"type": "int", "min": -1000, "max": 10000}),
                       ("u", {"type": "int", "min": -2000, "max": 4000})):
        http("POST", f"/index/i/field/{name}", {"options": opts})
    cols = t["cols"].tolist()
    for name in ("f", "g"):
        http("POST", f"/index/i/field/{name}/import",
             {"rowIDs": t[name].tolist(), "columnIDs": cols})
    for name in ("v", "u"):
        http("POST", f"/index/i/field/{name}/import",
             {"values": t[name].tolist(), "columnIDs": cols})
    http("POST", "/index/k", {"options": {"keys": True,
                                          "trackExistence": True}})
    http("POST", "/index/k/field/kf", {"options": {"type": "set",
                                                   "keys": True}})
    http("POST", "/index/k/field/n", {"options": {"type": "int", "min": 0,
                                                  "max": 1000}})
    http("POST", "/index/k/field/kf/import",
         {"rowKeys": t["kf"], "columnKeys": t["keys"]})
    http("POST", "/index/k/field/n/import",
         {"values": t["n"].tolist(), "columnKeys": t["keys"]})


def frames(t: dict) -> dict:
    """{shard: columns} of index i's dataframe: a row a record of f=1."""
    out = {}
    for s in range(SHARDS):
        sel = (t["cols"] // SHARD_WIDTH == s) & (t["f"] == 1)
        out[s] = {"_id": (t["cols"][sel] % SHARD_WIDTH).tolist(),
                  "x": (t["v"][sel] * 2).tolist()}
    return out


class LocalHTTP:
    """load()'s routes on one API, without a server."""

    def __init__(self, api):
        self.api = api

    def __call__(self, method, path, body):
        parts = path.strip("/").split("/")
        if len(parts) == 2:
            self.api.create_index(parts[1], body["options"])
        elif len(parts) == 4:
            self.api.create_field(parts[1], parts[3], body["options"])
        elif "values" in body:
            self.api.import_values(parts[1], parts[3], body.get("columnIDs"),
                                   body["values"],
                                   col_keys=body.get("columnKeys"))
        else:
            self.api.import_bits(parts[1], parts[3], body.get("rowIDs"),
                                 body.get("columnIDs"),
                                 row_keys=body.get("rowKeys"),
                                 col_keys=body.get("columnKeys"))


def col5(t: dict) -> int:
    return int(t["cols"][t["cols"] // SHARD_WIDTH == 5][0])


def queries(t: dict) -> list:
    """(index, PQL) of every family the cluster answers."""
    c5 = col5(t)
    i = [
        "Count(Row(f=1))",
        "Row(f=3)",
        "Count(Intersect(Row(f=1), Row(g=2)))",
        "Union(Row(f=1), Row(g=3))",
        "Count(Not(Row(f=1)))",
        "Count(Row(v > 5000))",
        "TopN(f, n=3)",
        "TopN(f)",
        "TopN(f, Row(g=2), n=2)",
        "TopK(f, k=2)",
        "Sum(field=v)",
        "Sum(Row(f=1), field=v)",
        "Min(field=v)",
        "Max(Row(g=1), field=v)",
        "MinRow(field=f)",
        "MaxRow(field=f)",
        "Rows(f)",
        "Rows(f, limit=2)",
        "UnionRows(Rows(g))",
        "GroupBy(Rows(f))",
        "GroupBy(Rows(f), Rows(g))",
        "GroupBy(Rows(f), aggregate=Sum(field=v))",
        "GroupBy(Rows(f), Rows(g), having=Condition(count > 430))",
        "GroupBy(Rows(f), Rows(g), limit=5)",
        "Distinct(Row(f=1), field=g)",
        "Distinct(Row(f=2), field=v)",
        "Count(Distinct(field=v))",
        "Count(Intersect(Row(f=1), Distinct(Row(g=2), field=f)))",
        "Percentile(field=v, nth=50)",
        "Percentile(field=v, nth=90, filter=Row(f=1))",
        "Sort(Row(f=1), field=v, limit=10)",
        "Sort(Row(f=2), field=v)",
        "Sort(All(), field=v, sort-desc=true, limit=5, offset=3)",
        "Extract(Row(g=3), Rows(f), Rows(v))",
        "Extract(Limit(Row(f=1), limit=20), Rows(f), Rows(v))",
        "Limit(Row(f=1), limit=5, offset=2)",
        "Count(Limit(Row(f=2), limit=30))",
        "Var(field=v)",
        "Var(field=v, filter=Row(f=1))",
        "Corr(field=v, field2=u)",
        f"IncludesColumn(Row(f=1), column={c5})",
        f"FieldValue(field=v, column={c5})",
        'Apply(Row(f=1), "v * 2", "sum")',
        'Apply(Row(f=1), "v + u")',
        "Arrow(Row(g=2))",
    ]
    k = [
        'Count(Row(kf="red"))',
        'Row(kf="blue")',
        "TopN(kf, n=2)",
        "Sum(field=n)",
        "GroupBy(Rows(kf))",
        "Distinct(field=kf)",
        "Extract(Row(n > 200), Rows(kf), Rows(n))",
        "Sort(All(), field=n, limit=3)",
        'IncludesColumn(Row(kf="red"), column="k0")',
        'FieldValue(field=n, column="k0")',
    ]
    return [("i", q) for q in i] + [("k", q) for q in k]


def set_and_aggregate_queries(t: dict) -> list:
    """The bitmap calls, Count, TopN/TopK, Sum, Min/Max, MinRow/MaxRow,
    Rows, UnionRows and GroupBy of queries()."""
    qs = queries(t)
    return qs[:qs.index(("i", "Distinct(Row(f=1), field=g)"))]


def decode_and_keyed_queries(t: dict) -> list:
    """The rest of queries(): Distinct, Percentile, Sort, Extract, Limit,
    Var, Corr, IncludesColumn, FieldValue, Apply, Arrow, the keyed index."""
    qs = queries(t)
    return qs[qs.index(("i", "Distinct(Row(f=1), field=g)")):]


# where the JAX package's cluster does not answer as one node does (the
# reference's faults, left in the JAX package; ROADMAP.md queue 3): Var
# and Corr fail (a node's float answer has no wire encoding); a Limit keeps
# a window a node; Apply's values and Arrow's rows come in the nodes' order;
# a keyed index's Extract merges its records in the order of their keys as
# strings; IncludesColumn and FieldValue of an unknown key fail
JAX_CLUSTER_DIFFERS = ("Var(", "Corr(", "Limit(", 'Apply(Row(f=1), "v + u")',
                       "Arrow(", "Extract(Row(n > 200)", 'column="gone"')


def jax_differs(q: str) -> bool:
    return any(d in q for d in JAX_CLUSTER_DIFFERS)


WRITES = [
    ("i", f"Set({3 * SHARD_WIDTH + 11}, f=7)"),
    ("i", f"Set({6 * SHARD_WIDTH + 12}, v=4242)"),
    ("i", "Clear(%d, f=1)"),          # a record of f=1, filled in
    ("i", "ClearRow(f=5)"),
    ("i", "Store(Intersect(Row(f=1), Row(g=2)), f=9)"),
    ("i", "Delete(Row(v > 9900))"),
    ("k", 'Set("knew", kf="purple")'),
    ("k", 'Set("k3", n=77)'),
    ("k", 'Clear("k5", kf="%s")'),
    ("k", 'Delete(Row(kf="teal"))'),
]

WRITE_READS = [
    ("i", "Count(Row(f=7))"), ("i", "Row(f=9)"), ("i", "Sum(field=v)"),
    ("i", "Count(Row(f=5))"), ("i", "TopN(f)"), ("i", "Count(All())"),
    ("k", 'Row(kf="purple")'), ("k", "Sum(field=n)"),
    ("k", "GroupBy(Rows(kf))"), ("k", "Count(All())"),
    ("k", 'IncludesColumn(All(), column="gone")'),
]


def writes(t: dict) -> list:
    c1 = int(t["cols"][t["f"] == 1][3])
    out = []
    for idx, q in WRITES:
        if "%d" in q:
            q = q % c1
        elif "%s" in q:
            q = q % t["kf"][5]
        out.append((idx, q))
    return out


def close_floats(a, b, rel: float = 1e-6) -> bool:
    """Equal JSON answers, floats within `rel` (the moment tests' bound)."""
    if isinstance(a, float) or isinstance(b, float):
        return isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and abs(a - b) <= rel * max(1.0, abs(a), abs(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(close_floats(a[k], b[k], rel)
                                            for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(close_floats(x, y, rel)
                                        for x, y in zip(a, b))
    return a == b


# a query of each family, asked again after each event of
# test_torch_cluster_events.py
EVENT_QUERIES = [
    ("i", "Count(Row(f=1))"), ("i", "Row(f=3)"), ("i", "TopN(f, n=3)"),
    ("i", "Sum(field=v)"), ("i", "Min(field=v)"), ("i", "MaxRow(field=f)"),
    ("i", "Rows(f)"), ("i", "GroupBy(Rows(f), Rows(g))"),
    ("i", "GroupBy(Rows(f), aggregate=Sum(field=v))"),
    ("i", "Distinct(Row(f=2), field=v)"),
    ("i", "Sort(Row(f=1), field=v, limit=10)"),
    ("i", "Extract(Row(g=3), Rows(f), Rows(v))"),
    ("i", "Var(field=v)"), ("i", "Corr(field=v, field2=u)"),
    ("i", 'Apply(Row(f=1), "v * 2", "sum")'),
    ("k", 'Count(Row(kf="red"))'), ("k", "TopN(kf, n=2)"),
    ("k", "Extract(Row(n > 200), Rows(kf), Rows(n))"),
]


@contextmanager
def world(jax: bool = True, data_dirs=None, jax_data_dirs=None):
    """{"single": API(device="cpu"), "port": TestCluster(3, replicas=2,
    device="cpu"), "jax": the JAX package's TestCluster(3, replicas=2) or
    None, "table": the table}, each loaded with table() and its frames
    (the clusters' nodes durable in `data_dirs`, `jax_data_dirs`)."""
    from featurebase_tpu.testing import TestCluster as JaxCluster
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.testing import TestCluster
    t = table()
    single = API(device="cpu")
    load(LocalHTTP(single), t)
    clusters = []
    try:
        pc = TestCluster(3, replicas=2, data_dirs=data_dirs, device="cpu")
        clusters.append(pc)
        jc = None
        if jax:
            jc = JaxCluster(3, replicas=2, data_dirs=jax_data_dirs)
            clusters.append(jc)
        for tc in clusters:
            load(lambda m, p, b, tc=tc: tc.http(0, m, p, b), t)
        # each node keeps the frames of every shard; a node's Arrow reads
        # those of the shards it is given
        for shard, cols in frames(t).items():
            for api in [single] + [a for tc in clusters for a in tc.apis]:
                api.dataframe_ingest("i", shard, columns=cols)
        yield {"single": single, "port": pc, "jax": jc, "table": t,
               "clusters": clusters}
    finally:
        for tc in clusters:
            tc.close()


def answer(tc, node: int, idx: str, q: str):
    """A node's JSON answer, or its error's status and message."""
    try:
        return tc.query(node, idx, q)
    except urllib.error.HTTPError as e:
        return {"status": e.code, "error": json.loads(e.read())["error"]}


def check(w, idx: str, q: str, nodes=(0, 1), jax: bool = True):
    """The port's nodes answer as the single node, exactly (Var and Corr
    within 1e-6), and so does the JAX cluster's node 0 where it answers as
    one node (jax_differs)."""
    from featurebase_tpu_torch.server.serialize import response_to_json
    want = response_to_json(w["single"].query(idx, q))
    for n in nodes:
        got = answer(w["port"], n, idx, q)
        assert close_floats(got, want), (n, q, got, want)
        if "Var(" not in q and "Corr(" not in q:
            assert got == want, (n, q)
    if jax and w["jax"] is not None and not jax_differs(q):
        assert answer(w["jax"], 0, idx, q) == want, q
