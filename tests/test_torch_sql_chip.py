"""The statements of chip_smoke.py's sql phase through both packages, at
a small size (test_torch_sql.Twin: the JAX API beside the port's
API(device="cpu"), equal answers or error statuses).

A 3-shard bench table of 6,000 records, made as chip_smoke.build_table makes
the card's (set fields f and g, int fields v and u), loaded through INSERT:
each statement of chip_smoke.SQL_PUSHDOWN equals its PQL counterpart
reshaped to SQL rows in both packages, and numpy's answer
(chip_smoke.sql_oracle) where it has one; the phase's writes
(chip_smoke.sql_writes) keep them equal to the model.  Then the dialect
corpus chip_smoke.SQL_DIALECT, which the phase runs on the card and on the
CPU.  Exact: the floats (AVG, VAR, CORR) come from the same integers in the
same order in both packages, and numpy's AVG divides the same two ints."""
import numpy as np
import pytest

import chip_smoke
from featurebase_tpu.sql import engine as jax_engine
from test_torch_sql import (Twin, error_form, one_torch_thread,  # noqa: F401
                            port_sql, sql_form, twin_sql)

# -- the pushdown statements of chip_smoke.py's sql phase at 3 shards -------------

N_SHARDS, PER_SHARD = 3, 2000


@pytest.fixture(scope="module")
def bench():
    """A 3-shard bench table of 6,000 records, as chip_smoke.build_table
    makes it at full size (set fields f and g, int fields v and u), loaded
    into both packages through INSERT; and its columns as numpy arrays."""
    from featurebase_tpu.core.consts import SHARD_WIDTH
    rng = np.random.default_rng(5)
    cols = np.concatenate([s * SHARD_WIDTH + np.sort(rng.choice(
        SHARD_WIDTH, PER_SHARD, replace=False)) for s in range(N_SHARDS)])
    n = cols.size
    f, g = rng.integers(0, 8, n), rng.integers(0, 4, n)
    v = rng.integers(-1000, 10000, n)
    v[rng.choice(n, 40, replace=False)] = 42
    u_has = rng.random(n) < 0.9
    u = np.clip(v // 3 + rng.integers(-600, 600, n), -500, 4000)
    tw = Twin()
    twin_sql(tw, "CREATE TABLE bench (_id ID, f IDSET, g IDSET, "
                 "v INT MIN -1000 MAX 10000, u INT MIN -500 MAX 4000)")
    for lo in range(0, n, 1000):
        rows = ", ".join(
            f"({cols[i]}, {f[i]}, {g[i]}, {v[i]}, "
            f"{u[i] if u_has[i] else 'NULL'})" for i in range(lo, lo + 1000))
        twin_sql(tw, f"INSERT INTO bench (_id, f, g, v, u) VALUES {rows}")
    return tw, dict(cols=cols, f=f, g=g, v=v, u=u, u_has=u_has)


@pytest.mark.parametrize("sql,pql,shape,kernels", chip_smoke.SQL_PUSHDOWN,
                         ids=[s[0][:60] for s in chip_smoke.SQL_PUSHDOWN])
def test_chip_pushdown_statements(bench, sql, pql, shape, kernels):
    """Each statement of the sql phase equals its PQL counterpart reshaped
    to SQL rows (chip_smoke.SQL_PUSHDOWN) in both packages, and numpy's
    answer where chip_smoke.sql_oracle has one."""
    tw, gen = bench
    got = twin_sql(tw, sql)["data"]
    for api in (tw.jax, tw.port):
        assert shape(api.query("bench", pql)) == got, (sql, pql)
    model = chip_smoke.WriteModel(gen)
    want = chip_smoke.sql_oracle(model).get(sql)
    if want is not None:
        assert got == want


def test_chip_sql_writes(bench):
    """The sql phase's writes (chip_smoke.sql_writes: an INSERT of new and
    existing records, a DELETE by _id and one by a pushable filter) on
    both packages, then the numpy-held statements against the model."""
    tw, gen = bench
    model = chip_smoke.WriteModel(gen)
    rng = np.random.default_rng(9)
    for sql in chip_smoke.sql_writes(model, rng, N_SHARDS, 200):
        twin_sql(tw, sql)
    want = chip_smoke.sql_oracle(model)
    for sql, rows in want.items():
        assert twin_sql(tw, sql)["data"] == rows, sql


def test_chip_dialect_corpus(tmp_path):
    """chip_smoke.SQL_DIALECT, the corpus the sql phase runs on the card
    and on the CPU, through both packages: each statement the same answer
    or error status ({tmp} is a directory of each package's own), and the
    same COPY file."""
    tw = Twin()
    for sql in chip_smoke.SQL_DIALECT:
        outs = []
        for api, run in ((tw.jax, jax_engine.execute_sql),
                         (tw.port, port_sql)):
            tmp = tmp_path / type(api).__module__
            tmp.mkdir(exist_ok=True)
            try:
                outs.append(sql_form(sql)(run(api, sql.replace("{tmp}",
                                                               str(tmp)))))
            except Exception as e:  # noqa: BLE001 — compared by status
                outs.append(error_form(e)[:2])
        assert outs[0] == outs[1], (sql, outs)
    files = [(tmp_path / m / "dt.csv").read_bytes() for m in (
        type(tw.jax).__module__, type(tw.port).__module__)]
    assert files[0] == files[1]
