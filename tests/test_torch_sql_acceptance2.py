"""The SQL acceptance corpora of tests/test_acceptance_sql3.py and
tests/test_acceptance_sql4.py through both packages, as
test_torch_sql_acceptance.py runs those of test_acceptance_sql.py and
test_acceptance_sql2.py: each case of their case lists (imported, not
copied) through the JAX test that owns it, on twins (the port's
API(device="cpu") beside the JAX API: equal answers or error statuses, and
the JAX test's own assert on the answer), and their flows (TestViews,
TestAlterTable, TestPercentile with the residual path against the
pushdown, TestDeleteShapes, TestSql1Joins, TestInsertShapes with
test_bulk_insert_csv, TestShow and the rest) the same way.  No tolerance:
the only floats are AVG and decimal columns, which both packages compute
from the same integers in the same order."""
import pytest

import test_acceptance_sql3 as sql3
import test_acceptance_sql4 as sql4
from test_torch_sql import (flows, jax_fixtures,  # noqa: F401
                            one_torch_thread, run_jax_case, run_jax_test, twin_sql)

# ORDER BY on a set column: the cases of its parametrize mark
ORDERBY_SET_CASES = sql3.test_orderby_set_column_rejected.pytestmark[0].args[1]

# (module, its test, the fixture it takes, its case list)
CASE_LISTS = [
    (sql3, "test_orderby", "db", sql3.ORDERBY_CASES),
    (sql3, "test_orderby_set_column_rejected", "db", ORDERBY_SET_CASES),
    (sql3, "test_subquery", "db", sql3.SUBQUERY_CASES),
    (sql3, "test_groupby", "db", sql3.GROUPBY_CASES),
    (sql3, "test_filter_predicates", "db", sql3.FPRED_CASES),
    (sql4, "test_string_functions", "db", sql4.STRING_CASES),
    (sql4, "test_string_function_errors", "db",
     [(s,) for s in sql4.STRING_ERRORS]),
    (sql4, "test_date_functions", "db", sql4.DATE_CASES),
    (sql4, "test_casts", "db", sql4.CAST_CASES),
    (sql4, "test_numbers_and_bools", "db", sql4.NUM_BOOL_CASES),
]
CASES = [(mod, fn, fx, case) for mod, fn, fx, cases in CASE_LISTS
         for case in cases]
FLOWS = [(sql3, n) for n in flows(sql3)] + [(sql4, n) for n in flows(sql4)]

@pytest.mark.parametrize("mod,fn,fx,case", CASES,
                         ids=[f"{fn}[{str(case[0])[:60]}]"
                              for _, fn, _, case in CASES])
def test_cases(jax_fixtures, mod, fn, fx, case):
    run_jax_case(mod, fn, jax_fixtures(mod, fx), case)


@pytest.mark.parametrize("mod,name", FLOWS,
                         ids=[f"{m.__name__}::{n}" for m, n in FLOWS])
def test_flows(jax_fixtures, mod, name, tmp_path):
    run_jax_test(mod, name, tmp_path, shared={"db": jax_fixtures(mod, "db")})


@pytest.mark.parametrize("nth", [0, 10, 50, 75, 99, 100])
def test_percentile_residual_path(jax_fixtures, nth):
    """TestPercentile.test_residual_path_matches_pushdown filters on
    s1 != 'nope', which the planner pushes down as a bitmap filter, so its
    PERCENTILE is a PQL Percentile too.  Under an arithmetic filter the
    aggregate runs in the volcano accumulator (sql/ops.py _pql_percentile),
    and in both packages it must give the pushdown's answer."""
    db = jax_fixtures(sql3, "db")
    push = twin_sql(db, f"SELECT percentile(i1, {nth}) AS p FROM pct")
    resid = twin_sql(db, f"SELECT percentile(i1, {nth}) AS p FROM pct "
                         "WHERE i1 + 0 > 0")
    assert resid["data"] == push["data"]


def test_percentile_residual_decimal_defect(jax_fixtures):
    """A defect of the JAX package that the port keeps (ROADMAP.md's
    watch-list): the volcano accumulator bisects decimal values in integer
    space when every value is integral, so over pct's d1 (10.0 .. 13.0)
    the residual median is 11 where the pushdown's is 11.5.  Both packages
    answer alike (twin_sql)."""
    db = jax_fixtures(sql3, "db")
    push = twin_sql(db, "SELECT percentile(d1, 50) AS p FROM pct")
    resid = twin_sql(db, "SELECT percentile(d1, 50) AS p FROM pct "
                         "WHERE i1 + 0 > 0")
    assert (push["data"], resid["data"]) == ([[11.5]], [[11]])
