"""SQL-backed DAX controller state (reference: dax/controller/sqldb —
the reference keeps controller registry/balancer state in a SQL database
with schema migrations).

Own copy of featurebase_tpu/dax/sqldb.py: the same tables, the same two
migrations and the same JSON columns, so that a controller.sqlite written
by either package opens in the other's.

SQLite (stdlib) with a `schema_migrations` version table; every
`save_state` is ONE transaction — a crash mid-persist leaves the
previous committed state intact.  An existing controller.json from an
older deployment is imported on first open.
"""
from __future__ import annotations

import json
import sqlite3
import threading
from typing import Optional

MIGRATIONS = [
    # v1: core directive state
    """
    CREATE TABLE directive (id INTEGER PRIMARY KEY CHECK (id = 1),
                            version INTEGER NOT NULL);
    CREATE TABLE assignments (table_name TEXT NOT NULL,
                              shard INTEGER NOT NULL,
                              worker TEXT,
                              PRIMARY KEY (table_name, shard));
    CREATE TABLE databases (name TEXT PRIMARY KEY,
                            options TEXT NOT NULL);
    CREATE TABLE table_dbs (table_name TEXT PRIMARY KEY,
                            db TEXT NOT NULL);
    CREATE TABLE schema_defs (ordinal INTEGER PRIMARY KEY,
                              def TEXT NOT NULL);
    """,
    # v2: SQL views + translate-store snapshots
    """
    CREATE TABLE views (name TEXT PRIMARY KEY, sql TEXT NOT NULL);
    CREATE TABLE index_keys (table_name TEXT PRIMARY KEY,
                             state TEXT NOT NULL);
    CREATE TABLE field_keys (key TEXT PRIMARY KEY,
                             state TEXT NOT NULL);
    """,
]


class ControllerDB:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self._migrate()

    def close(self):
        self.conn.close()

    def _migrate(self):
        with self._lock, self.conn:
            self.conn.execute(
                "CREATE TABLE IF NOT EXISTS schema_migrations "
                "(version INTEGER PRIMARY KEY)")
            done = {r[0] for r in self.conn.execute(
                "SELECT version FROM schema_migrations")}
            for i, ddl in enumerate(MIGRATIONS, start=1):
                if i in done:
                    continue
                self.conn.executescript(ddl)
                self.conn.execute(
                    "INSERT INTO schema_migrations (version) VALUES (?)",
                    (i,))

    def migration_version(self) -> int:
        row = self.conn.execute(
            "SELECT MAX(version) FROM schema_migrations").fetchone()
        return int(row[0] or 0)

    # -- state ----------------------------------------------------------------

    def save_state(self, state: dict):
        """Replace the whole controller state in ONE transaction (the
        crash-consistency unit; reference: sqldb transactional models)."""
        with self._lock, self.conn:
            c = self.conn
            c.execute("DELETE FROM directive")
            c.execute("INSERT INTO directive (id, version) VALUES (1, ?)",
                      (int(state.get("version", 0)),))
            c.execute("DELETE FROM assignments")
            c.executemany(
                "INSERT INTO assignments (table_name, shard, worker) "
                "VALUES (?, ?, ?)",
                [(t, int(s), w)
                 for t, m in state.get("assignments", {}).items()
                 for s, w in m.items()])
            c.execute("DELETE FROM databases")
            c.executemany(
                "INSERT INTO databases (name, options) VALUES (?, ?)",
                [(n, json.dumps(o))
                 for n, o in state.get("databases", {}).items()])
            c.execute("DELETE FROM table_dbs")
            c.executemany(
                "INSERT INTO table_dbs (table_name, db) VALUES (?, ?)",
                list(state.get("tableDbs", {}).items()))
            c.execute("DELETE FROM schema_defs")
            c.executemany(
                "INSERT INTO schema_defs (ordinal, def) VALUES (?, ?)",
                [(i, json.dumps(d))
                 for i, d in enumerate(state.get("schema", []))])
            c.execute("DELETE FROM views")
            c.executemany(
                "INSERT INTO views (name, sql) VALUES (?, ?)",
                list(state.get("views", {}).items()))
            c.execute("DELETE FROM index_keys")
            c.executemany(
                "INSERT INTO index_keys (table_name, state) VALUES (?, ?)",
                [(t, json.dumps(d))
                 for t, d in state.get("indexKeys", {}).items()])
            c.execute("DELETE FROM field_keys")
            c.executemany(
                "INSERT INTO field_keys (key, state) VALUES (?, ?)",
                [(k, json.dumps(d))
                 for k, d in state.get("fieldKeys", {}).items()])

    def load_state(self) -> Optional[dict]:
        c = self.conn
        row = c.execute("SELECT version FROM directive").fetchone()
        if row is None:
            return None
        assignments: dict = {}
        for t, s, w in c.execute(
                "SELECT table_name, shard, worker FROM assignments"):
            assignments.setdefault(t, {})[str(s)] = w
        return {
            "version": int(row[0]),
            "assignments": assignments,
            "databases": {n: json.loads(o) for n, o in c.execute(
                "SELECT name, options FROM databases")},
            "tableDbs": dict(c.execute(
                "SELECT table_name, db FROM table_dbs")),
            "schema": [json.loads(d) for (d,) in c.execute(
                "SELECT def FROM schema_defs ORDER BY ordinal")],
            "views": dict(c.execute("SELECT name, sql FROM views")),
            "indexKeys": {t: json.loads(d) for t, d in c.execute(
                "SELECT table_name, state FROM index_keys")},
            "fieldKeys": {k: json.loads(d) for k, d in c.execute(
                "SELECT key, state FROM field_keys")},
        }
