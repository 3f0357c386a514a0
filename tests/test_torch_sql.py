"""SQL through the port (featurebase_tpu_torch.sql.engine.execute_sql over
API(device="cpu")) against the JAX package's execute_sql over its API,
statement by statement.

A Twin holds one API of each package.  twin_sql runs a statement on both
and requires the same answer, or the same error (its type, status and
message).  The same answer is the same schema and every cell equal in value
and in type, where a numpy scalar the JAX package leaves compares as its
Python value; each cell of the port's answer must be a plain int, float,
str, bool, None or a list of those, and json.dumps must take the answers of
both packages.  The corpora hold floats only in AVG, VAR, CORR and decimal
columns, which both packages compute from the same integers in the same
order, so they are compared exactly, with no tolerance.

The JAX package's own SQL tests run on twins: run_jax_test calls one of
them, with its fixtures, while the module globals ``API`` and
``execute_sql`` of its module are Twin and twin_sql, so that each of its
asserts runs on the answer both packages gave.  This file runs those of
tests/test_sql.py, test_sql_extended.py and test_sql_dialect.py, all but
two: TestPlanGraph's HTTP route (the server, ROADMAP.md queue 1 item 12;
plan_graph itself is held here) and TestDistributedSQL, which runs on a
three-node cluster of the port's nodes in test_torch_cluster.py (its
statements run here on one node too).  test_torch_sql_acceptance.py and
test_torch_sql_acceptance2.py run the acceptance corpora.

Besides: plan_graph's operator trees for the same SELECTs (the pushdown
decisions, which the CPU cannot show through launch counters), COPY files,
fb_exec_requests, the system tables (fb_database_info's platform is the one
difference), and SQL-made WAL entries and checkpoints reopened across the
packages.  test_torch_sql_chip.py holds the statements of chip_smoke.py's
sql phase."""
import contextlib
import csv
import inspect
import json

import numpy as np
import pytest
import torch

import test_sql
import test_sql_dialect
import test_sql_extended
from featurebase_tpu.server.api import API as JaxAPI
from featurebase_tpu.sql import engine as jax_engine
from featurebase_tpu.sql import planner as jax_planner
from featurebase_tpu.sql import system_tables as jax_system_tables
from featurebase_tpu_torch.server.api import API
from featurebase_tpu_torch.sql import engine, planner, system_tables
from test_torch_api import canon

# system tables whose rows differ between the packages by nature: request
# ids and times, each package's own metrics registry, and the platform
VOLATILE = ("fb_exec_requests", "fb_performance_counters",
            "fb_database_info")
PLAIN = (int, float, str, bool, type(None))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Twin:
    """The JAX API and the port's API(device="cpu"), driven together.  An
    attribute that is a method runs on both (equal answers by
    test_torch_api.canon, or equal errors) and returns the JAX package's
    answer; any other attribute is the port's.  A data directory d is the
    JAX API's, and d + "-port" the port's."""

    def __init__(self, data_dir=None, **kw):
        self.jax = JaxAPI(data_dir=data_dir, **kw)
        self.port = API(device="cpu", data_dir=data_dir and
                        data_dir + "-port", **kw)

    def __getattr__(self, name):
        attr = getattr(self.port, name)
        if not callable(attr):
            return attr
        return lambda *a, **kw: on_both(
            self, lambda api: getattr(api, name)(*a, **kw), canon)


def error_form(e: Exception) -> tuple:
    return type(e).__name__, getattr(e, "status", None), str(e)


def on_both(twin: Twin, fn, form):
    """fn(api) on both APIs of `twin`: the forms of the two answers must be
    equal, or both must raise the same error (the JAX one is raised)."""
    outs = []
    for api in (twin.jax, twin.port):
        try:
            outs.append((None, fn(api)))
        except AssertionError:
            raise
        except Exception as e:  # noqa: BLE001 — compared across packages
            outs.append((e, None))
    (je, j), (pe, p) = outs
    if je is not None or pe is not None:
        assert je is not None and pe is not None and \
            error_form(je) == error_form(pe), (je, pe, j, p)
        raise je
    assert form(j) == form(p), (form(j), form(p))
    return j


def cell(v):
    """A cell of either package by type and value (numpy scalars as their
    Python values)."""
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, list):
        return [cell(x) for x in v]
    return type(v).__name__, v


def plain(v) -> bool:
    return type(v) in PLAIN or type(v) is list and all(plain(x) for x in v)


def sql_form(sql: str):
    volatile = any(t in sql.lower() for t in VOLATILE)

    def form(out):
        json.dumps(out)
        if volatile:
            return out["schema"]
        return out["schema"], [[cell(v) for v in row] for row in out["data"]]
    return form


def port_sql(api, sql):
    """The port's execute_sql, its cells held to plain Python types."""
    out = engine.execute_sql(api, sql)
    bad = [v for row in out["data"] for v in row if not plain(v)]
    assert not bad, (sql, bad[:5])
    return out


def twin_sql(twin, sql):
    """One statement on both packages (see the module docstring)."""
    return on_both(twin, lambda api: port_sql(api, sql) if isinstance(
        api, API) else jax_engine.execute_sql(api, sql), sql_form(sql))


@contextlib.contextmanager
def on_twins(mod):
    """The JAX test module `mod` with Twin and twin_sql for its API and
    execute_sql."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "API", Twin)
        mp.setattr(mod, "execute_sql", twin_sql)
        yield


def make_fixture(mod, name, owner=None, made=None):
    """A fixture of the JAX test module `mod` (or of its test class
    `owner`), built by its own function, with the fixtures it takes."""
    made = made if made is not None else {}
    if name not in made:
        fx = getattr(type(owner), name, None) if owner is not None else None
        fn = (fx or getattr(mod, name)).__wrapped__
        params = list(inspect.signature(fn).parameters)
        args = [make_fixture(mod, p, owner, made) for p in params
                if p != "self"]
        with on_twins(mod):
            made[name] = fn(owner, *args) if params[:1] == ["self"] \
                else fn(*args)
    return made[name]


def run_jax_test(mod, name: str, tmp_path, shared=None):
    """The JAX test `name` ("test_x" or "TestY.test_x") of module `mod` on
    twins: its fixtures built afresh, but for those in `shared`."""
    cls_name, _, fn_name = name.rpartition(".")
    owner = getattr(mod, cls_name)() if cls_name else None
    fn = getattr(owner, fn_name) if owner is not None else getattr(mod,
                                                                   fn_name)
    made = {"tmp_path": tmp_path, **(shared or {})}
    args = [make_fixture(mod, p, owner, made)
            for p in inspect.signature(fn).parameters]
    with on_twins(mod):
        fn(*args)


@pytest.fixture(scope="module")
def jax_fixtures():
    """get(mod, name): the module fixture `name` of the JAX test module
    `mod`, built once on twins."""
    made = {}

    def get(mod, name):
        key = (mod.__name__, name)
        if key not in made:
            made[key] = make_fixture(mod, name)
        return made[key]
    return get


def run_jax_case(mod, fn_name: str, fixture, case):
    """One case of the JAX module's parametrized test `fn_name`, on the
    twin `fixture`."""
    with on_twins(mod):
        getattr(mod, fn_name)(fixture, *case)


def flows(mod, skip=()):
    """The names of the unparametrized tests of a JAX module."""
    names = []
    for n, obj in vars(mod).items():
        if n.startswith("Test") and isinstance(obj, type):
            names += [f"{n}.{m}" for m in vars(obj) if m.startswith("test_")]
        elif n.startswith("test_") and callable(obj) and \
                not hasattr(obj, "pytestmark"):
            names.append(n)
    return [n for n in names if not n.startswith(tuple(skip))]


# -- the three SQL test files of the JAX package, on twins -------------------

JAX_TESTS = ([(test_sql, n) for n in flows(test_sql)]
             + [(test_sql_extended, n) for n in flows(
                 test_sql_extended, skip=["TestDistributedSQL"])]
             + [(test_sql_dialect, n) for n in flows(
                 test_sql_dialect, skip=["TestPlanGraph"])])


@pytest.mark.parametrize("mod,name", JAX_TESTS,
                         ids=[f"{m.__name__}::{n}" for m, n in JAX_TESTS])
def test_jax_sql_tests(mod, name, tmp_path):
    run_jax_test(mod, name, tmp_path)


def test_distributed_sql_statements_on_one_node():
    """TestDistributedSQL's statements (tests/test_sql_extended.py:248),
    on one node: 29 records, one a shard."""
    tw = Twin()
    twin_sql(tw, "CREATE TABLE d (_id ID, v INT MIN 0 MAX 10000)")
    ids = list(range(1, 30))
    vals = ", ".join(f"({i * 1048576 + 1}, {i})" for i in ids)
    twin_sql(tw, f"INSERT INTO d (_id, v) VALUES {vals}")
    assert twin_sql(tw, "SELECT SUM(v) FROM d")["data"] == [[sum(ids)]]
    assert twin_sql(tw, "SELECT COUNT(*) FROM d WHERE v >= 15")["data"] == \
        [[15]]


# -- plan_graph ---------------------------------------------------------------

PLAN_SELECTS = [
    # TestPlanGraph's statement (tests/test_sql_dialect.py:92)
    "SELECT _id FROM pg WHERE v > 1 ORDER BY _id LIMIT 3",
    "SELECT COUNT(*) FROM pg WHERE f = 1 AND v > 5",
    "SELECT SUM(v), AVG(v), MIN(v), MAX(v) FROM pg WHERE f = 2",
    "SELECT PERCENTILE(v, 50), VAR(v), CORR(v, u) FROM pg",
    "SELECT f, COUNT(*) FROM pg GROUP BY f",
    "SELECT f, SUM(v) FROM pg GROUP BY f HAVING SUM(v) > 3",
    "SELECT u, COUNT(*) FROM pg GROUP BY u",
    "SELECT DISTINCT f FROM pg",
    "SELECT COUNT(DISTINCT v) FROM pg",
    "SELECT _id, v FROM pg WHERE v = 4 AND u + 1 > 2",
    "SELECT p._id, q.v FROM pg p INNER JOIN pg q ON p._id = q.u",
    "SELECT _id FROM pg WHERE v IN (SELECT u FROM pg WHERE f = 1)",
    "SELECT s.v FROM (SELECT v FROM pg WHERE f = 1) s ORDER BY s.v",
    "SELECT value FROM generate_series(1, 3)",
    "SELECT name FROM fb_table_info",
    "SELECT 1 + 2",
]


@pytest.fixture(scope="module")
def plan_twin():
    tw = Twin()
    twin_sql(tw, "CREATE TABLE pg (_id ID, f IDSET, v INT MIN 0 MAX 100, "
                 "u INT MIN 0 MAX 100)")
    twin_sql(tw, "INSERT INTO pg (_id, f, v, u) VALUES (1, [1], 4, 2), "
                 "(2, [1, 2], 5, 1), (3, [2], 4, 9)")
    return tw


@pytest.mark.parametrize("sql", PLAN_SELECTS)
def test_plan_graph(plan_twin, sql):
    """Both packages build the same plan-operator tree: the same pushdown
    decisions (the CPU's launch counters stay 0 by the device rule)."""
    graph = on_both(plan_twin, lambda api: (planner if isinstance(api, API)
                                            else jax_planner).plan_graph(
        api, sql), lambda g: g)
    if sql == PLAN_SELECTS[0]:
        names = []

        def walk(n):
            names.append(n["op"])
            for c in n.get("children", []):
                walk(c)
        walk(graph["plans"][0])
        assert any("Scan" in n for n in names)
        assert any("Top" in n or "OrderBy" in n for n in names)


def test_plan_graph_statements(plan_twin):
    g = on_both(plan_twin, lambda api: (planner if isinstance(api, API)
                                        else jax_planner).plan_graph(
        api, "CREATE TABLE x (_id ID); SELECT 1"), lambda g: g)
    assert g == {"plans": [{"op": "CreateTable", "children": []},
                           {"op": "PlanOpProjection",
                            "children": [{"op": "PlanOpStatic",
                                          "children": []}]}]}


# -- COPY, exec requests, system tables ------------------------------------------


def test_copy_files_equal(tmp_path):
    """COPY t TO a file from each package: the same bytes; each package's
    file read back by the other's COPY ... FROM."""
    tw = Twin()
    twin_sql(tw, "CREATE TABLE src (_id ID, region STRING, tags IDSET, "
                 "qty INT MIN 0 MAX 100, price DECIMAL(2))")
    twin_sql(tw, "INSERT INTO src (_id, region, tags, qty, price) VALUES "
                 "(1, 'east', [3, 4], 10, 1.25), (2, 'west', [4], 20, NULL), "
                 "(7, NULL, NULL, 30, 2.50)")
    paths = {}
    for name, api, run in (("jax", tw.jax, jax_engine.execute_sql),
                           ("port", tw.port, port_sql)):
        paths[name] = str(tmp_path / f"{name}.csv")
        assert run(api, f"COPY src TO '{paths[name]}'")["data"] == [[3]]
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    rows = list(csv.reader(open(paths["port"])))
    assert rows[0] == ["_id", "region", "tags", "qty", "price"]
    back = Twin()
    for api, run, path in ((back.jax, jax_engine.execute_sql, paths["port"]),
                           (back.port, port_sql, paths["jax"])):
        assert run(api, f"COPY dst FROM '{path}'")["data"] == [[3]]
    for sql in ("SELECT * FROM dst", "SHOW COLUMNS FROM dst",
                "SELECT SUM(qty), COUNT(*) FROM dst",
                "SELECT region, COUNT(*) FROM dst GROUP BY region"):
        twin_sql(back, sql)


def test_exec_requests_after_good_and_bad():
    tw = Twin()
    twin_sql(tw, "SELECT 1")
    with pytest.raises(Exception):
        twin_sql(tw, "SELECT * FROM nowhere")
    with pytest.raises(Exception):
        twin_sql(tw, "SELEKT 2")
    out = {}
    for name, api, run in (("jax", tw.jax, jax_engine.execute_sql),
                           ("port", tw.port, port_sql)):
        out[name] = run(api, "SELECT * FROM fb_exec_requests")
    assert out["jax"]["schema"] == out["port"]["schema"]
    assert [r[1:3] for r in out["jax"]["data"]] == \
        [r[1:3] for r in out["port"]["data"]] == [
            ["SELECT 1", "complete"], ["SELECT * FROM nowhere", "error"],
            ["SELEKT 2", "error"]]
    for rid, _, _, ms in out["port"]["data"]:
        assert isinstance(rid, str) and len(rid) == 36
        assert type(ms) is int and ms >= 0
    got = twin_sql(tw, "SELECT sql, status FROM fb_exec_requests "
                       "WHERE status = 'error'")
    assert len(got["schema"]["fields"]) == 2


@pytest.mark.parametrize("table", sorted(system_tables.SYSTEM_TABLES))
def test_system_tables(table):
    """Every system table through both packages; fb_database_info's
    platform is the torch device type where the JAX package says "tpu",
    and the rows of fb_exec_requests and fb_performance_counters are each
    package's own (their schemas are equal)."""
    assert system_tables.SYSTEM_TABLES == jax_system_tables.SYSTEM_TABLES
    tw = Twin()
    twin_sql(tw, "CREATE TABLE st (_id ID, a INT MIN 0 MAX 9, b STRINGSET)")
    twin_sql(tw, "CREATE VIEW sv AS SELECT _id FROM st")
    twin_sql(tw, "CREATE DATABASE sdb WITH units 2")
    twin_sql(tw, "CREATE FUNCTION inc(@x int) RETURNS int AS (x + 1)")
    twin_sql(tw, "INSERT INTO st (_id, a, b) VALUES (1, 2, ['p'])")
    out = twin_sql(tw, f"SELECT * FROM {table}")
    if table == "fb_database_info":
        port = port_sql(tw.port, "SELECT * FROM fb_database_info")
        assert out["data"] == [["featurebase_tpu", "tpu", 1 << 20]]
        assert port["data"] == [["featurebase_tpu", "cpu", 1 << 20]]
    elif table == "fb_performance_counters":
        port = port_sql(tw.port, "SELECT * FROM fb_performance_counters")
        assert all(type(n) is str and type(v) is int
                   for n, v in port["data"])


# -- durability across the packages ------------------------------------------------

SQL_STATE = [
    "CREATE TABLE w (_id ID, v INT MIN 0 MAX 100, s STRING)",
    "INSERT INTO w (_id, v, s) VALUES (1, 10, 'a'), (2, 20, 'b'), "
    "(3, 30, 'a')",
    "CREATE VIEW wv AS SELECT _id, v FROM w WHERE s = 'a'",
    "CREATE DATABASE wdb WITH units 3",
    "CREATE FUNCTION twice(@x int) RETURNS int AS (x * 2)",
]
SQL_LATER = [
    "DELETE FROM w WHERE _id = 2",
    "CREATE VIEW wv2 AS SELECT COUNT(*) AS n FROM w",
    "DROP DATABASE wdb",
    "CREATE DATABASE wdb2",
    "CREATE FUNCTION plus(@x int, @y int) RETURNS int AS (x + y)",
    "DROP FUNCTION twice",
]
SQL_READS = [
    "SELECT * FROM wv", "SELECT * FROM wv2", "SHOW VIEWS", "SHOW DATABASES",
    "SHOW FUNCTIONS", "SELECT plus(twice_gone, 1) FROM w",
    "SELECT plus(v, 1) FROM w ORDER BY _id", "SELECT * FROM fb_databases",
    "SELECT * FROM fb_views", "SELECT _id, v, s FROM w ORDER BY _id",
]


def answers(api, run):
    out = []
    for sql in SQL_READS:
        try:
            out.append(sql_form(sql)(run(api, sql)))
        except Exception as e:  # noqa: BLE001 — compared across packages
            out.append(error_form(e)[:2])
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("checkpoint", [False, True])
def test_sql_state_reopens_in_the_other_package(tmp_path, writer,
                                                checkpoint):
    """Views, databases, functions and rows made by SQL, with or without a
    checkpoint between two rounds of statements, reopen in the other
    package's API(data_dir=...) with the same answers."""
    d = str(tmp_path / "node")
    kinds = {"jax": (lambda: JaxAPI(data_dir=d), jax_engine.execute_sql),
             "port": (lambda: API(device="cpu", data_dir=d), port_sql)}
    make, run = kinds[writer]
    api = make()
    for sql in SQL_STATE:
        run(api, sql)
    if checkpoint:
        api.checkpoint()
    for sql in SQL_LATER:
        run(api, sql)
    want = answers(api, run)
    other_make, other_run = kinds["port" if writer == "jax" else "jax"]
    other = other_make()
    assert getattr(other, "wal_replay_errors", 0) == 0
    assert answers(other, other_run) == want


def test_device_rule():
    """execute_sql runs where its API runs: API() wants CUDA and raises
    without it; API(device="cpu") answers on the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(Exception):
            API()
    api = API(device="cpu")
    assert api.executor.device.type == "cpu"
    out = port_sql(api, "SELECT platform FROM fb_database_info")
    assert out["data"] == [["cpu"]]
