"""The SQL acceptance corpora of tests/test_acceptance_sql.py and
tests/test_acceptance_sql2.py through both packages.

Each case of their case lists (imported, not copied) runs through the JAX
test that owns it, on twins (test_torch_sql.Twin): the statement goes
through the JAX package's execute_sql and the port's over
API(device="cpu"), the two answers must be equal (schema, and every cell in
value and type) or raise the same error status, and the JAX test's own
assert holds the answer to the case's expected rows.  Their module fixtures
are built by their own functions on twins; their flows (TestSQLWrites,
TestTimestampLiteralsAndKeyedInsert, test_rangeq_both_null_errors) run the
same way.  No tolerance: the only floats are AVG and decimal columns, which
both packages compute from the same integers in the same order."""
import pytest

import test_acceptance_sql as sql1
import test_acceptance_sql2 as sql2
from test_torch_sql import (flows, jax_fixtures,  # noqa: F401
                            one_torch_thread, run_jax_case, run_jax_test)

# (module, its test, the fixture it takes, its case list)
CASE_LISTS = [
    (sql1, "test_sql_acceptance", "db", sql1.CASES),
    (sql1, "test_sql_acceptance_t2", "db2", sql1.CASES2),
    (sql1, "test_cast_corpus", "db", sql1.CAST_CASES),
    (sql2, "test_null_semantics", "db", sql2.NULL_CASES),
    (sql2, "test_joins", "db", sql2.JOIN_CASES),
    (sql2, "test_time_quantum", "db", sql2.TQ_CASES),
    (sql2, "test_operator_edges", "db", sql2.OP_CASES),
    (sql2, "test_keyed", "kdb", sql2.KEYED_CASES),
    (sql2, "test_cast_and_functions", "db", sql2.CAST_DATE_CASES),
]
CASES = [(mod, fn, fx, case) for mod, fn, fx, cases in CASE_LISTS
         for case in cases]
FLOWS = [(sql1, n) for n in flows(sql1)] + [(sql2, n) for n in flows(sql2)]

@pytest.mark.parametrize("mod,fn,fx,case", CASES,
                         ids=[f"{fn}[{case[0][:60]}]"
                              for _, fn, _, case in CASES])
def test_cases(jax_fixtures, mod, fn, fx, case):
    run_jax_case(mod, fn, jax_fixtures(mod, fx), case)


@pytest.mark.parametrize("mod,name", FLOWS,
                         ids=[f"{m.__name__}::{n}" for m, n in FLOWS])
def test_flows(jax_fixtures, mod, name, tmp_path):
    run_jax_test(mod, name, tmp_path, shared={"db": jax_fixtures(mod, "db")})
