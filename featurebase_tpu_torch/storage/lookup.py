"""External lookup database for ExternalLookup() queries.

Reference: executor.go:4357 executeExternalLookup — the evaluated bitmap's
columns (or keys) are bound as an array parameter ($1) of a SQL statement
run against a configured Postgres (`holder.lookupDB`), read results coming
back as an ExtractedTable, writes running in a transaction.

Here: a small adapter protocol (`query`/`execute` taking the SQL text
and the id array) so any database client can plug in, with a
stdlib-sqlite3 adapter in-box.  SQLite has no array type, so the adapter expands the `$1`
placeholder into an IN-list parameter set — the statement semantics
(`... WHERE id = ANY($1)` in Postgres) map to `... WHERE id IN ($1)` here.

Own copy of featurebase_tpu/storage/lookup.py.
"""
from __future__ import annotations

import threading
from typing import Any, List, Sequence, Tuple


class LookupError_(Exception):
    pass


class SQLiteLookup:
    """Lookup adapter over a sqlite3 database file (or :memory:)."""

    def __init__(self, path: str):
        import sqlite3
        self.path = path
        self._local = threading.local()
        self._sqlite3 = sqlite3

    def _conn(self):
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._sqlite3.connect(self.path)
            self._local.conn = conn
        return conn

    @staticmethod
    def _expand(sql: str, arg: Sequence[Any]) -> Tuple[str, list]:
        marks = ", ".join("?" for _ in arg)
        if "$1" not in sql:
            raise LookupError_("lookup query must reference $1 (the "
                               "bitmap's column array)")
        return sql.replace("$1", f"({marks})"), list(arg)

    def query(self, sql: str, arg: Sequence[Any]
              ) -> Tuple[List[Tuple[str, str]], List[tuple]]:
        """-> ([(col_name, type)], rows)."""
        if not arg:
            return [], []
        q, params = self._expand(sql, arg)
        cur = self._conn().execute(q, params)
        names = [d[0] for d in cur.description or []]
        rows = cur.fetchall()
        header = []
        for i, n in enumerate(names):
            sample = next((r[i] for r in rows if r[i] is not None), None)
            if isinstance(sample, int):
                t = "int64"
            elif isinstance(sample, float):
                t = "float64"
            else:
                t = "string"
            header.append((n, t))
        return header, rows

    def execute(self, sql: str, arg: Sequence[Any]) -> None:
        """Write statement in a transaction (reference: tx.ExecContext)."""
        if not arg:
            return
        q, params = self._expand(sql, arg)
        conn = self._conn()
        with conn:  # transaction: commit on success, rollback on raise
            conn.execute(q, params)

    def close(self):
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


def open_lookup(dsn: str):
    """DSN -> adapter.  sqlite:PATH (or a bare path) for the in-box
    adapter; other schemes raise with a pointer to the protocol."""
    if dsn.startswith("sqlite:"):
        return SQLiteLookup(dsn[len("sqlite:"):])
    if "://" not in dsn:
        return SQLiteLookup(dsn)
    raise LookupError_(
        f"unsupported lookup DSN {dsn!r}: provide an adapter object with "
        "query(sql, ids) / execute(sql, ids) (see storage/lookup.py)")
