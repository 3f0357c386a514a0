"""The port's slice end to end against the JAX executor.

A Holder is built with the JAX package on the fuzz-style dataset of
tests/test_fuzz_differential.py, saved with featurebase_tpu's snapshot
writer and loaded into the port with featurebase_tpu_torch.storage.snapshot.
Both executors answer the Count/TopN query mix over identical bits; answers
must match exactly (counts, columns, pair order)."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import ExecError, Executor
from featurebase_tpu_torch.executor.results import PairsField
from featurebase_tpu_torch.model.field import FieldOptions
from featurebase_tpu_torch.model.index import Holder
from featurebase_tpu_torch.model.row import Row
from featurebase_tpu_torch.ops import cuda_kernels as ck
from featurebase_tpu_torch.storage import snapshot

N_RECORDS = 2000
N_SHARDS = 3
F_ROWS, G_ROWS = 6, 4
V_LO, V_HI = -120, 500

QUERIES = [
    "Count(Intersect(Row(f=1), Row(g=2)))",
    "Count(Union(Row(f=1), Row(f=2), Row(g=3)))",
    "Count(Difference(Row(f=1), Row(g=0)))",
    "Count(Xor(Row(f=1), Row(g=1)))",
    "Count(Not(Row(f=1)))",
    "Count(Row(v > 300))",
    "Count(Row(v <= -10))",
    "Count(Row(v == 42))",
    "Count(Row(0 < v < 100))",
    "Count(Row(v != 7))",
    "Count(Row(v >= -120))",
    "Count(Row(v < 9999))",
    "Count(Row(v > -9999))",
    "Count(Intersect(Row(f=1), Row(v > 300)))",
    "Count(Shift(Row(f=1), n=1))",
    "Count(Shift(Row(f=2), n=40))",
    "Count(Union())",
    "Count(All())",
    "Count(ConstRow(columns=[1, 5, 2097153]))",
    "Row(f=3)",
    "Intersect(Row(g=1), Row(v >= 200))",
    "Shift(Row(g=0), n=3)",
    "TopN(f, n=5)",
    "TopN(f)",
    "TopN(f, Row(g=2), n=5)",
    "TopN(f, Row(v > 300), n=5)",
    "TopK(f, k=3, filter=Row(g=1))",
    "Options(Count(Row(f=1)), shards=[0, 2])",
    "Options(Count(Row(f=1)), shards=[0, 5, 63])",
    "Options(TopN(f, n=3), shards=[1])",
]


def canon(result):
    if isinstance(result, (int, np.integer)):
        return ("value", int(result))
    if hasattr(result, "pairs"):
        return ("pairs", [(p.id, p.count) for p in result.pairs])
    return ("row", [int(c) for c in result.columns()])


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    rng = np.random.default_rng(2024)
    cols = np.sort(rng.choice(N_SHARDS * SHARD_WIDTH, size=N_RECORDS,
                              replace=False))
    f = rng.integers(0, F_ROWS, size=N_RECORDS)
    g = rng.integers(0, G_ROWS, size=N_RECORDS)
    v = rng.integers(V_LO, V_HI, size=N_RECORDS)
    extra = rng.random(N_RECORDS) < 0.2
    f2 = rng.integers(0, F_ROWS, size=N_RECORDS)
    holder = JaxHolder()
    idx = holder.create_index("fz")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", JaxFieldOptions(type="int", min=V_LO, max=V_HI))
    idx.field("f").import_bits(f, cols)
    idx.field("f").import_bits(f2[extra], cols[extra])
    idx.field("g").import_bits(g, cols)
    idx.field("v").import_values(cols, v)
    idx.mark_exists(cols)
    path = str(tmp_path_factory.mktemp("snap") / "holder")
    jax_snapshot.save(holder, path)
    port_holder = snapshot.load(path)
    assert port_holder.index("fz").field("v").bit_depth == \
        idx.field("v").bit_depth
    return JaxExecutor(holder), Executor(port_holder, device="cpu")


@pytest.mark.parametrize("query", QUERIES)
def test_query_mix_matches_jax(engines, query):
    jax_e, port_e = engines
    want = canon(jax_e.execute("fz", query)[0])
    got = canon(port_e.execute("fz", query)[0])
    assert got == want


@pytest.mark.parametrize("query", ["TopN(f, n=4)", "TopN(f, Row(g=3))"])
def test_topn_per_shard_fallback_matches_jax(engines, query):
    """Above ROWS_STACKED_MAX_BYTES TopN counts shard by shard with the
    2-D row-count forms (popcount_rows / count_and_rows)."""
    jax_e, port_e = engines
    fallback = Executor(port_e.holder, device="cpu")
    fallback.ROWS_STACKED_MAX_BYTES = 0
    port_e.holder.index("fz").field("f")._topn_cache.clear()
    assert canon(fallback.execute("fz", query)[0]) == \
        canon(jax_e.execute("fz", query)[0])


def test_rank_cache_serves_repeat_topn(engines):
    _, port_e = engines
    fld = port_e.holder.index("fz").field("f")
    fld._topn_cache.clear()
    first = canon(port_e.execute("fz", "TopN(f, n=3)")[0])
    assert fld._topn_cache
    assert canon(port_e.execute("fz", "TopN(f, n=3)")[0]) == first


def test_results_are_port_types(engines):
    _, port_e = engines
    row, count, pairs = port_e.execute(
        "fz", "Row(f=1) Count(Row(f=1)) TopN(f, n=2)")
    assert isinstance(row, Row) and isinstance(pairs, PairsField)
    assert all(seg.dtype == torch.int32 for seg in row.segments.values())
    assert row.count() == count


@pytest.mark.parametrize("query,family", [
    ("Arrow()", "Arrow"), ("ExternalLookup(query='x')", "ExternalLookup"),
    ('Apply("v + 1")', "Apply"),
])
def test_unported_families_raise(engines, query, family):
    """The three families that raised NotImplementedError before the port
    had them now answer as the JAX executor does: Arrow() without a
    dataframe and ExternalLookup without a lookup database raise its
    error, Apply answers its values."""
    jax_e, port_e = engines
    try:
        want = ("ok", jax_e.execute("fz", query))
    except Exception as e:  # noqa: BLE001 — the JAX package's answer
        want = ("error", str(e))
    if want[0] == "error":
        with pytest.raises(ExecError) as err:
            port_e.execute("fz", query)
        assert str(err.value) == want[1]
    else:
        assert port_e.execute("fz", query) == want[1]
    assert family in query


def _answer(result):
    """A comparable form of a Percentile, Extract, Sort or Count answer of
    either package."""
    if hasattr(result, "col_ids"):
        return (list(result.col_ids), [list(v) for v in result.field_values])
    if hasattr(result, "val"):
        return (result.val, result.count)
    return result


@pytest.mark.parametrize("query,family", [
    ("Percentile(field=v, nth=50)", "Percentile"),
    ("Extract(All(), Rows(f))", "Extract"),
    ("Sort(field=v)", "Sort"), ("Count(Distinct(field=v))", "Distinct"),
    ("Var(field=v)", "Var"), ("Set(5, f=1)", "Set"),
])
def test_ported_families_match_jax(engines, query, family):
    """The families that raised before they were ported (the same queries
    as test_unported_families_raise had) answer as the JAX executor; the
    Set writes the same bit into both holders."""
    jax_e, port_e = engines
    got = port_e.execute("fz", query)[0]
    assert _answer(got) == _answer(jax_e.execute("fz", query)[0]), family


def test_writes_through_import_api_reach_the_next_query():
    holder = Holder()
    idx = holder.create_index("w")
    idx.create_field("f")
    idx.create_field("v", FieldOptions(type="int", min=-5, max=5))
    e = Executor(holder, device="cpu")
    idx.field("f").set_bit(1, 10)
    idx.field("v").import_values(np.array([10, 11]), np.array([-3, 4]))
    idx.mark_exists(np.array([10, 11]))
    assert e.execute("w", "Count(Row(f=1))") == [1]
    idx.field("f").set_bit(1, SHARD_WIDTH + 3)
    assert e.execute("w", "Count(Row(f=1))") == [2]
    assert e.execute("w", "Count(Row(v < 0))") == [1]
    assert canon(e.execute("w", "TopN(f)")[0]) == ("pairs", [(1, 2)])


def test_default_device_is_cuda_and_never_the_cpu():
    holder = Holder()
    if torch.cuda.is_available():
        assert Executor(holder).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Executor(holder)
    assert Executor(holder, device="cpu").device.type == "cpu"


def test_cpu_executor_launches_no_kernel(engines):
    _, port_e = engines
    ck.reset_launches()
    port_e.execute("fz", "Count(Row(v > 300)) TopN(f, Row(g=1), n=2) "
                         "Percentile(field=v, nth=50) Distinct(field=v) "
                         "Var(field=v)")
    assert ck.launches() == {"plan_eval": 0, "row_counts": 0,
                             "bsi_sum_planes": 0, "bsi_min_max": 0,
                             "pair_counts": 0, "bsi_sum_groups": 0,
                             "bsi_decode": 0, "bsi_decode_gather": 0,
                             "percentile_counts": 0, "var_moments": 0,
                             "corr_moments": 0}


def test_port_imports_neither_jax_nor_featurebase_tpu():
    """Every module of the port (walked by pkgutil, dax/ among them), and
    the API, SQL, the servers and a DAX service driven on the CPU, import
    neither JAX nor the JAX package.  featurebase_tpu is a prefix of
    featurebase_tpu_torch: match the JAX package's modules exactly, not by
    prefix."""
    code = (
        "import importlib, pkgutil, sys, featurebase_tpu_torch\n"
        "for m in pkgutil.walk_packages(featurebase_tpu_torch.__path__,\n"
        "                               'featurebase_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "mesh = featurebase_tpu_torch.parallel.mesh.make_mesh(\n"
        "    devices=['cpu'])\n"
        "ex = featurebase_tpu_torch.executor.executor.Executor(\n"
        "    featurebase_tpu_torch.model.index.Holder(), mesh=mesh)\n"
        "assert ex.mesh.size == 1 and ex.device.type == 'cpu'\n"
        "api = featurebase_tpu_torch.server.api.API(device='cpu')\n"
        "api.create_index('i'); api.create_field('i', 'v', {'type': 'int'})\n"
        "api.import_values('i', 'v', [1, 2], [3, 4])\n"
        "assert api.query('i', 'Apply(All(), \"v + 1\", \"sum\")') == [[9]]\n"
        "out = featurebase_tpu_torch.sql.engine.execute_sql(\n"
        "    api, 'SELECT SUM(v), COUNT(*) FROM i WHERE v > 3')\n"
        "assert out['data'] == [[4, 1]], out\n"
        "from featurebase_tpu_torch.server.http_server import Server\n"
        "from featurebase_tpu_torch.server.grpc_server import (\n"
        "    GRPCServer, make_channel_callables)\n"
        "from featurebase_tpu_torch.client import Client\n"
        "from featurebase_tpu_torch.proto import pilosa_pb2 as pb\n"
        "import grpc\n"
        "srv, gs = Server(api=api).start(), GRPCServer(api=api).start()\n"
        "assert Client(srv.url).query('i', 'Sum(field=v)')[0]['value'] == 7\n"
        "ch = grpc.insecure_channel(gs.address)\n"
        "t = make_channel_callables(ch)['QueryPQLUnary'](\n"
        "    pb.QueryPQLRequest(index='i', pql='Count(All())'))\n"
        "assert t.rows[0].columns[0].uint64_val == 2\n"
        "ch.close(); gs.stop(); srv.stop()\n"
        "from featurebase_tpu_torch.dax.service import DaxService\n"
        "with DaxService(n_computers=2, device='cpu') as dax:\n"
        "    dax.queryer.create_index('d')\n"
        "    dax.queryer.create_field('d', 'f', {'type': 'set'})\n"
        "    dax.queryer.import_bits('d', 'f', [1, 1], [3, 1 << 20])\n"
        "    assert dax.queryer.query('d', 'Count(Row(f=1))') == [2]\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'featurebase_tpu' or m.startswith('featurebase_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_neither_jax_nor_featurebase_tpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "chip_smoke.py")) as fh:
        src = fh.read()
    for line in src.splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]):
            assert words[1].split(".")[0] not in ("jax", "featurebase_tpu"), \
                line


def test_keyed_index_translates_like_jax(tmp_path):
    """Row and column keys resolve through the port's copy of the
    translate stores, loaded from the JAX package's snapshot."""
    holder = JaxHolder()
    from featurebase_tpu.model.index import IndexOptions
    idx = holder.create_index("k", IndexOptions(keys=True))
    idx.create_field("f", JaxFieldOptions(keys=True))
    ids = idx.translate_store.create_keys(["r1", "r2", "r3"])
    rows = idx.row_translation("f").create_keys(["a", "b"])
    cols = np.array([ids["r1"], ids["r2"], ids["r3"]])
    idx.field("f").import_bits(np.array([rows["a"], rows["a"], rows["b"]]),
                               cols)
    idx.mark_exists(cols)
    path = str(tmp_path / "keyed")
    jax_snapshot.save(holder, path)
    port_e = Executor(snapshot.load(path), device="cpu")
    jax_e = JaxExecutor(holder)
    for q in ['Row(f="a")', 'Count(Row(f="b"))', 'TopN(f)',
              'Count(Row(f="missing"))']:
        want, got = jax_e.execute("k", q)[0], port_e.execute("k", q)[0]
        assert canon(got) == canon(want), q
        if hasattr(want, "pairs"):
            assert [p.key for p in got.pairs] == [p.key for p in want.pairs]
        elif not isinstance(want, (int, np.integer)):
            assert got.keys == want.keys
