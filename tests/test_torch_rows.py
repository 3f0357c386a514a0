"""Rows, UnionRows and Limit through both executors.

The acceptance cases of tests/test_acceptance_pql.py (Rows, UnionRows,
Limit; :206-222, :337-339) and tests/test_acceptance_pql2.py (ROWS_CASES
:45-56, the UnionRows and All cases of BITMAP_CASES :77-80) run over one
Holder each, built with the JAX package, saved with its snapshot writer and
loaded into the port.  Each Rows case runs on both of Rows' paths: the
stacked verify (one kernel-B launch over the candidate tile) and the
per-shard scan (ROWS_STACKED_MAX_BYTES = 0), forced alike on both
executors.  Keyed `like=` and time-range Rows are among the cases.
Answers must be equal: row ids or keys in order, columns in order."""
import numpy as np
import pytest
import torch

from featurebase_tpu.core.consts import SHARD_WIDTH as SW
from featurebase_tpu.executor.executor import Executor as JaxExecutor
from featurebase_tpu.model.field import FieldOptions as JaxFieldOptions
from featurebase_tpu.model.index import Holder as JaxHolder
from featurebase_tpu.storage import snapshot as jax_snapshot
from featurebase_tpu_torch.executor.executor import Executor, FieldNotFound
from featurebase_tpu_torch.storage import snapshot

F0 = [0, 1, SW + 2, 2 * SW + 4]
F1 = [1, 2, 65537]
F2 = [SW - 1, 2 * SW + 4]
ALL_COLS = sorted({*F0, *F1, *F2, 9})
V = {0: -1000, 1: -3, 2: 0, SW + 2: 7, 2 * SW + 4: 1000}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Test files run in parallel worker processes: one intra-op thread
    each keeps torch's CPU ops from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def norm(r):
    if isinstance(r, list):
        return ("rows", list(r))
    if isinstance(r, (int, np.integer)):
        return ("value", int(r))
    return ("row", [int(c) for c in r.columns()], r.keys)


def engines(holder, tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp(name) / "holder")
    jax_snapshot.save(holder, path)
    port = Executor(snapshot.load(path), device="cpu")
    return JaxExecutor(holder), port


def per_shard_pair(jax_e, port_e):
    """Fresh executors over the same holders with Rows' stacked verify
    off."""
    j = JaxExecutor(jax_e.holder)
    p = Executor(port_e.holder, device="cpu")
    j.ROWS_STACKED_MAX_BYTES = 0
    p.ROWS_STACKED_MAX_BYTES = 0
    return j, p


@pytest.fixture(scope="module")
def acceptance(tmp_path_factory):
    """The schema and bits of tests/test_acceptance_pql.py::env."""
    holder = JaxHolder()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("m", JaxFieldOptions(type="mutex"))
    idx.create_field("b", JaxFieldOptions(type="bool"))
    idx.create_field("v", JaxFieldOptions(type="int", min=-1000, max=1000))
    idx.create_field("t", JaxFieldOptions(type="time", time_quantum="YMDH"))
    idx.create_field("kf", JaxFieldOptions(keys=True))
    e = JaxExecutor(holder)
    for row, cols in ((0, F0), (1, F1), (2, F2)):
        for c in cols:
            idx.field("f").set_bit(row, c)
    for c in (1, 2, SW + 2):
        idx.field("g").set_bit(5, c)
    idx.field("m").set_bit(10, 1)
    idx.field("m").set_bit(20, 2)
    idx.field("m").set_bit(10, SW + 2)
    idx.field("b").set_bit(1, 1)
    idx.field("b").set_bit(0, 2)
    for c, val in V.items():
        idx.field("v").set_value(c, val)
    tf = idx.field("t")
    tf.set_bit(1, 1, timestamp="2001-02-03T04:00")
    tf.set_bit(1, 2, timestamp="2001-02-04T00:00")
    tf.set_bit(2, 1, timestamp="2002-01-01T00:00")
    tf.set_bit(3, SW + 2, timestamp="2002-06-01T00:00")
    e.execute("i", 'Set(1, kf="alpha")')
    e.execute("i", f'Set({SW + 2}, kf="alpha")')
    e.execute("i", 'Set(2, kf="beta")')
    idx.mark_exists(np.array(ALL_COLS))
    return engines(holder, tmp_path_factory, "acc")


# tests/test_acceptance_pql.py:206-222 and :337-339, with keyed and time
# cases of the same shape
ACCEPTANCE_ROWS = [
    "Rows(f)", "Rows(f, limit=2)", "Rows(f, previous=0)",
    "Rows(f, previous=1)", "Rows(f, column=1)", "Rows(f, column=2)",
    f"Rows(f, column={SW - 1})", "Rows(f, in=[0, 2])", "Rows(f, in=[7])",
    "Rows(m)", "Rows(kf)", 'Rows(kf, like="al%")', 'Rows(kf, like="%a")',
    'Rows(kf, like="x%")', 'Rows(kf, like="b_ta")',
    "Rows(f, previous=0, limit=1)", "Rows(g)", "Rows(b)",
    'Rows(kf, column=2)', "Rows(f, in=[0, 2], limit=1)",
    "Rows(t)", "Rows(t, from=2001-01-01T00:00, to=2001-12-31T00:00)",
    "Rows(t, from=2002-01-01T00:00)", "Rows(t, to=2002-03-01T00:00)",
    "Rows(t, from=2002-01-01T00:00, column=1)",
    f"Rows(t, from=2001-01-01T00:00, column={SW + 2})",
]
ACCEPTANCE_BITMAPS = [
    "UnionRows(Rows(f))", "Count(UnionRows(Rows(m)))",
    "UnionRows(Rows(f, limit=1), Rows(m))", "UnionRows(Rows(kf))",
    "UnionRows(Rows(t, from=2002-01-01T00:00))",
    "Limit(Row(f=0), limit=2)", "Limit(Row(f=0), limit=2, offset=1)",
    "Limit(Row(f=0), limit=0)", "Limit(All(), offset=5)",
    "Count(Limit(Row(f=0), limit=3))", "All(limit=3)",
    "All(limit=2, offset=2)", "Options(Limit(All(), limit=2), shards=[1])",
]


@pytest.mark.parametrize("path", ["stacked", "per_shard"])
@pytest.mark.parametrize("pql", ACCEPTANCE_ROWS)
def test_acceptance_rows_match_jax(acceptance, pql, path):
    jax_e, port_e = acceptance
    if path == "per_shard":
        jax_e, port_e = per_shard_pair(jax_e, port_e)
    assert norm(port_e.execute("i", pql)[0]) == \
        norm(jax_e.execute("i", pql)[0])


@pytest.mark.parametrize("path", ["stacked", "per_shard"])
@pytest.mark.parametrize("pql", ACCEPTANCE_BITMAPS)
def test_acceptance_union_rows_and_limit_match_jax(acceptance, pql, path):
    jax_e, port_e = acceptance
    if path == "per_shard":
        jax_e, port_e = per_shard_pair(jax_e, port_e)
    assert norm(port_e.execute("i", pql)[0]) == \
        norm(jax_e.execute("i", pql)[0])


def test_acceptance_answers_by_hand(acceptance):
    """A few of the acceptance corpus's hand-computed answers."""
    _, port_e = acceptance
    assert port_e.execute("i", "Rows(f)")[0] == [0, 1, 2]
    assert port_e.execute("i", 'Rows(kf, like="al%")')[0] == ["alpha"]
    assert port_e.execute("i", "Rows(f, column=1)")[0] == [0, 1]
    assert [int(c) for c in port_e.execute(
        "i", "UnionRows(Rows(f))")[0].columns()] == sorted({*F0, *F1, *F2})
    assert [int(c) for c in port_e.execute(
        "i", "Limit(All(), offset=5)")[0].columns()] == ALL_COLS[5:]


def test_rows_of_unknown_field_errors(acceptance):
    _, port_e = acceptance
    with pytest.raises(FieldNotFound, match="nope"):
        port_e.execute("i", "Rows(nope)")


# -- tests/test_acceptance_pql2.py's multi-shard dataset ---------------------

@pytest.fixture(scope="module")
def tranche2(tmp_path_factory):
    holder = JaxHolder()
    idx = holder.create_index("i")
    idx.create_field("f")
    idx.create_field("g")
    idx.create_field("v", JaxFieldOptions(type="int"))
    cols = np.array([1, 2, 7, SW + 3, 2 * SW + 5])
    idx.field("f").import_bits(np.array([1, 1, 10, 2, 3]), cols)
    idx.field("g").import_bits(np.array([0, 1, 0, 0, 1]), cols)
    idx.field("v").import_values(cols, np.array([10, 20, 50, 30, 40]))
    idx.mark_exists(cols)
    return engines(holder, tmp_path_factory, "t2")


TRANCHE2 = [
    "Rows(f)", "Rows(f, limit=2)", "Rows(f, previous=1)",
    "Rows(f, previous=2, limit=1)", "Rows(f, column=1)", "Rows(f, column=7)",
    "Rows(f, from=2, to=10)", "Rows(f, in=[1,3])", "Rows(f, in=[99])",
    "Rows(g)", "UnionRows(Rows(f, limit=2))", "UnionRows(Rows(f, in=[10,3]))",
    "All(limit=3)", "All(limit=2, offset=2)",
    "Limit(Row(g=0), limit=2)", "Limit(Row(g=0), limit=1, offset=1)",
]


@pytest.mark.parametrize("path", ["stacked", "per_shard"])
@pytest.mark.parametrize("pql", TRANCHE2)
def test_tranche2_rows_match_jax(tranche2, pql, path):
    jax_e, port_e = tranche2
    if path == "per_shard":
        jax_e, port_e = per_shard_pair(jax_e, port_e)
    assert norm(port_e.execute("i", pql)[0]) == \
        norm(jax_e.execute("i", pql)[0])


def test_rows_paths_run_their_scans(acceptance, monkeypatch):
    """The stacked verify counts one candidate tile; the per-shard path
    scans each shard's fragments (ops/rowscan.py)."""
    from featurebase_tpu_torch.ops import rowscan
    calls = []
    real = rowscan.scan_fragments
    monkeypatch.setattr(rowscan, "scan_fragments",
                        lambda *a: calls.append(1) or real(*a))
    _, port_e = acceptance
    assert port_e.execute("i", "Rows(f)")[0] == [0, 1, 2] and not calls
    _, per_shard = per_shard_pair(*acceptance)
    assert per_shard.execute("i", "Rows(f)")[0] == [0, 1, 2]
    assert len(calls) == 3   # one scan a shard
