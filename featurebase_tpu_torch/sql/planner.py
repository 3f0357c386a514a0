"""SQL planner: compiles parsed SQL onto the PQL layer.

Mirrors the reference's sql3 planner/optimizer lowering rules (reference:
sql3/planner/executionplanner.go:59 CompilePlan; planoptimizer.go:86 —
filter pushdown into PQL scans:501, GroupBy->PQLGroupBy/PQLAggregate:661,876,
Distinct->PQLDistinctScan:753, top pushdown:980):

- WHERE subtrees that map onto bitmap algebra are pushed into the PQL scan
  (Row/Union/Intersect/Not/ConstRow/BSI Conditions); the rest runs as a
  residual row filter.
- SELECT of pure aggregates over pushable filters lowers to PQL
  Count/Sum/Min/Max/Percentile/Distinct calls — no row materialization.
- GROUP BY over set/mutex/bool/time columns with count/sum aggregates lowers
  to PQL GroupBy(Rows...).
- Everything else (joins, expressions, functions, HAVING, ORDER BY,
  DISTINCT) runs in the volcano operator tree (sql/ops.py) over the
  Extract()-scanned rows.

All PQL execution goes through api.query(), so SQL runs on the API's
device (CUDA unless the API was given device="cpu"), is distributed
across a cluster, and its writes are WAL-logged.

Own copy of featurebase_tpu/sql/planner.py.
"""
from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from featurebase_tpu_torch.pql.ast import Call, Condition, Query
from featurebase_tpu_torch.server.api import API, APIError
from featurebase_tpu_torch.sql import ast as sa
from featurebase_tpu_torch.sql import ops as so
from featurebase_tpu_torch.sql.ops import (PlanOp, PlanOpDistinct,
                                           PlanOpFilter, PlanOpGroupBy,
                                           PlanOpNestedLoops, PlanOpOrderBy,
                                           PlanOpProjection, PlanOpStatic,
                                           PlanOpTop, SQLRuntimeError,
                                           agg_slot_name, eval_expr,
                                           make_env, repr_expr)
from featurebase_tpu_torch.sql.parser import SQLError, parse_sql
from featurebase_tpu_torch.sql.system_tables import (is_system_table,
                                                     run_system_table)

_TYPE_TO_FIELD = {
    "id": {"type": "mutex"},
    "string": {"type": "mutex", "keys": True},
    "idset": {"type": "set"},
    "stringset": {"type": "set", "keys": True},
    "int": {"type": "int"},
    "decimal": {"type": "decimal"},
    "timestamp": {"type": "timestamp"},
    "bool": {"type": "bool"},
}

_FIELD_TO_SQL = {
    ("mutex", False): "id", ("mutex", True): "string",
    ("set", False): "idset", ("set", True): "stringset",
    ("time", False): "idset", ("time", True): "stringset",
    ("int", False): "int", ("decimal", False): "decimal",
    ("timestamp", False): "timestamp", ("bool", False): "bool",
}

_UNIT_SECONDS = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}


def plan_and_execute(api: API, sql: str) -> dict:
    try:
        stmts = parse_sql(sql)
    except SQLError as e:
        raise APIError(f"SQL parse error: {e}", 400)
    so.set_user_functions(api.holder.sql_functions)
    out = None
    for stmt in stmts:
        try:
            out = _execute_stmt(api, stmt)
        except (SQLRuntimeError, ValueError) as e:
            raise APIError(str(e), 400)
    return out if out is not None else _ok()


def plan_graph(api: API, sql: str) -> dict:
    """Compile (don't run) a SELECT and return its plan-operator tree
    (reference: /sql-exec-graph endpoint, http_handler.go:538)."""
    try:
        stmts = parse_sql(sql)
    except SQLError as e:
        raise APIError(f"SQL parse error: {e}", 400)
    graphs = []
    for stmt in stmts:
        if isinstance(stmt, sa.Select):
            op = SelectCompiler(api).compile(stmt)
            graphs.append(op.plan_json())
        else:
            graphs.append({"op": type(stmt).__name__, "children": []})
    return {"plans": graphs}


def _copy(api: API, stmt: sa.Copy) -> dict:
    """COPY src TO dst (table clone, reference: sql3 COPY
    defs_copy.go) or COPY table TO/FROM 'file.csv' (file extension)."""
    import csv as _csv
    if stmt.direction == "clone":
        src = api.holder.index(stmt.table)
        if src is None:
            raise APIError(
                f"table or view not found: {stmt.table}", 404)
        if api.holder.index(stmt.path) is not None:
            raise APIError(f"table already exists: {stmt.path}", 409)
        # clone schema via SHOW CREATE-equivalent field options
        api.create_index(stmt.path, {
            "keys": src.options.keys,
            "trackExistence": src.options.track_existence})
        for f in src.public_fields():
            api.create_field(stmt.path, f.name, f.options.to_json())
        sel = parse_sql(f'SELECT * FROM "{stmt.table}"')[0]
        out = _execute_stmt(api, sel)
        names = [fd["name"] for fd in out["schema"]["fields"]]
        n = len(out["data"])
        if n:
            _insert(api, sa.Insert(stmt.path, names, out["data"]))
        return {"schema": {"fields": [{"name": "rows", "type": "int"}]},
                "data": [[n]]}
    if stmt.direction == "to":
        sel = parse_sql(f'SELECT * FROM "{stmt.table}"')[0]
        out = _execute_stmt(api, sel)
        with open(stmt.path, "w", newline="") as fh:
            w = _csv.writer(fh)
            w.writerow([f["name"] for f in out["schema"]["fields"]])
            for row in out["data"]:
                w.writerow(["" if v is None else
                            (";".join(str(x) for x in v)
                             if isinstance(v, list) else v)
                            for v in row])
        n = len(out["data"])
    else:
        from featurebase_tpu_torch.ingest.batch import csv_ingest
        n = csv_ingest(api, stmt.table, stmt.path, id_column="_id")
    return {"schema": {"fields": [{"name": "rows", "type": "int"}]},
            "data": [[n]]}


def _execute_stmt(api: API, stmt) -> dict:
    if isinstance(stmt, sa.CreateTable):
        return _create_table(api, stmt)
    if isinstance(stmt, sa.AlterTable):
        return _alter_table(api, stmt)
    if isinstance(stmt, sa.DropTable):
        if stmt.if_exists and api.holder.index(stmt.name) is None:
            return _ok()
        api.delete_index(stmt.name)
        return _ok()
    if isinstance(stmt, sa.CreateView):
        # a view may not shadow an existing table (reference:
        # defs_views.go "create-view-should-fail")
        if api.holder.index(stmt.name) is not None:
            raise APIError(
                f"table or view already exists: {stmt.name}", 409)
        api.create_sql_view(stmt.name, stmt.select_sql,
                            if_not_exists=stmt.if_not_exists)
        return _ok()
    if isinstance(stmt, sa.DropView):
        api.delete_sql_view(stmt.name, if_exists=stmt.if_exists)
        return _ok()
    if isinstance(stmt, sa.AlterView):
        # redefine: view must exist (reference: defs_views.go alter-view)
        if stmt.name not in api.holder.sql_views:
            raise APIError(f"view not found: {stmt.name}", 404)
        api.delete_sql_view(stmt.name)
        api.create_sql_view(stmt.name, stmt.select_sql)
        return _ok()
    if isinstance(stmt, sa.CreateDatabase):
        h = api.holder
        if stmt.name in h.sql_databases and not stmt.if_not_exists:
            raise APIError(f"database already exists: {stmt.name}", 409)
        h.sql_databases[stmt.name] = dict(stmt.options)
        api._log({"op": "create_database", "name": stmt.name,
                  "options": dict(stmt.options)})
        return _ok()
    if isinstance(stmt, sa.DropDatabase):
        h = api.holder
        if stmt.name not in h.sql_databases:
            if stmt.if_exists:
                return _ok()
            raise APIError(f"database not found: {stmt.name}", 404)
        del h.sql_databases[stmt.name]
        api._log({"op": "drop_database", "name": stmt.name})
        return _ok()
    if isinstance(stmt, sa.CreateFunction):
        h = api.holder
        name = stmt.name.lower()
        if name in h.sql_functions and not stmt.if_not_exists:
            raise APIError(f"function already exists: {stmt.name}", 409)
        h.sql_functions[name] = {
            "params": [p for p, _ in stmt.params],
            "returns": stmt.returns, "body": stmt.body_src}
        api._log({"op": "create_function", "name": name,
                  "def": h.sql_functions[name]})
        return _ok()
    if isinstance(stmt, sa.DropFunction):
        h = api.holder
        name = stmt.name.lower()
        if name not in h.sql_functions:
            if stmt.if_exists:
                return _ok()
            raise APIError(f"function not found: {stmt.name}", 404)
        del h.sql_functions[name]
        api._log({"op": "drop_function", "name": name})
        return _ok()
    if isinstance(stmt, sa.Copy):
        return _copy(api, stmt)
    if isinstance(stmt, sa.Show):
        return _show(api, stmt)
    if isinstance(stmt, sa.Insert):
        return _insert(api, stmt)
    if isinstance(stmt, sa.BulkInsert):
        return _bulk_insert(api, stmt)
    if isinstance(stmt, sa.Delete):
        return _delete(api, stmt)
    if isinstance(stmt, sa.Select):
        op = SelectCompiler(api).compile(stmt)
        schema, rows = op.run()
        return {"schema": {"fields": [{"name": n, "type": t}
                                      for n, t in schema]},
                "data": rows}
    raise APIError(f"unsupported statement {type(stmt).__name__}", 400)


def _ok() -> dict:
    return {"schema": {"fields": []}, "data": []}


# -- DDL -----------------------------------------------------------------------

def _field_options(typ: str, opts: dict) -> dict:
    fo = dict(_TYPE_TO_FIELD.get(typ, {"type": typ}))
    if "min" in opts:
        fo["min"] = int(opts["min"])
    if "max" in opts:
        fo["max"] = int(opts["max"])
    if "scale" in opts:
        fo["scale"] = int(opts["scale"])
    if "timeunit" in opts:
        fo["timeUnit"] = str(opts["timeunit"])
    if "timequantum" in opts:
        fo["timeQuantum"] = str(opts["timequantum"])
        fo["type"] = "time"
    if "cachetype" in opts:
        fo["cacheType"] = str(opts["cachetype"])
    if "ttl" in opts:
        fo["ttl"] = opts["ttl"]
    return fo


def _create_table(api: API, stmt: sa.CreateTable) -> dict:
    keyed = any(name == "_id" and typ == "string"
                for name, typ, _ in stmt.columns)
    api.create_index(stmt.name, {"keys": keyed},
                     if_not_exists=stmt.if_not_exists)
    for name, typ, opts in stmt.columns:
        if name == "_id":
            continue
        api.create_field(stmt.name, name, _field_options(typ, opts),
                         if_not_exists=stmt.if_not_exists)
    return _ok()


def _alter_table(api: API, stmt: sa.AlterTable) -> dict:
    idx = api.holder.index(stmt.table)
    if idx is None:
        raise APIError(f"table not found: {stmt.table}", 404)
    if stmt.action == "add":
        name, typ, opts = stmt.column
        api.create_field(stmt.table, name, _field_options(typ, opts))
        return _ok()
    if stmt.action == "drop":
        api.delete_field(stmt.table, stmt.column[0])
        return _ok()
    raise APIError("ALTER TABLE RENAME is not supported", 400)


def _show(api: API, stmt: sa.Show) -> dict:
    if stmt.what == "tables":
        return {
            "schema": {"fields": [{"name": "name", "type": "string"}]},
            "data": [[n] for n in sorted(api.holder.indexes)],
        }
    if stmt.what == "databases":
        names = sorted(api.holder.sql_databases) or ["featurebase_tpu"]
        return {
            "schema": {"fields": [{"name": "name", "type": "string"}]},
            "data": [[n] for n in names],
        }
    if stmt.what == "functions":
        return {
            "schema": {"fields": [{"name": "name", "type": "string"},
                                  {"name": "body", "type": "string"}]},
            "data": [[n, d["body"]] for n, d in
                     sorted(api.holder.sql_functions.items())],
        }
    if stmt.what == "views":
        return {
            "schema": {"fields": [{"name": "name", "type": "string"}]},
            "data": [[n] for n in
                     sorted(getattr(api.holder, "sql_views", {}))],
        }
    idx = api.holder.index(stmt.table)
    if idx is None:
        raise APIError(f"table not found: {stmt.table}", 404)
    if stmt.what == "create_table":
        cols = ["_id " + ("string" if idx.options.keys else "id")]
        for f in idx.public_fields():
            t = _FIELD_TO_SQL.get((f.options.type, f.options.keys),
                                  f.options.type)
            cols.append(f"{f.name} {t}")
        ddl = f"CREATE TABLE {idx.name} ({', '.join(cols)})"
        return {"schema": {"fields": [{"name": "ddl", "type": "string"}]},
                "data": [[ddl]]}
    return {
        "schema": {"fields": [{"name": "name", "type": "string"},
                              {"name": "type", "type": "string"}]},
        "data": [[f.name, f.options.type] for f in idx.public_fields()],
    }


# -- INSERT / DELETE --------------------------------------------------------------

def _insert(api: API, stmt: sa.Insert) -> dict:
    idx = api.holder.index(stmt.table)
    if idx is None:
        raise APIError(f"table not found: {stmt.table}", 404)
    cols = stmt.columns or ["_id"] + [f.name for f in idx.public_fields()]
    if "_id" not in cols:
        raise APIError("INSERT requires _id column", 400)
    id_pos = cols.index("_id")
    # batch per field, then route through the (distributed, WAL-logged)
    # import API (reference: INSERT lowers to import, sql3 planner opinsert)
    bit_batches: Dict[str, dict] = {}
    val_batches: Dict[str, dict] = {}
    for row in stmt.rows:
        if len(row) != len(cols):
            raise APIError("INSERT row arity mismatch", 400)
        rid = row[id_pos]
        for ci, cname in enumerate(cols):
            if cname == "_id":
                continue
            val = row[ci]
            if val is None:
                continue
            f = idx.field(cname)
            if f is None:
                raise APIError(f"column not found: {cname}", 400)
            if f.is_bsi():
                b = val_batches.setdefault(cname, {"cols": [], "values": []})
                b["cols"].append(rid)
                b["values"].append(val)
            else:
                b = bit_batches.setdefault(cname, {"rows": [], "cols": []})
                vals = val if isinstance(val, list) else [val]
                for v in vals:
                    if f.options.type == "bool":
                        v = 1 if v in (True, 1, "true") else 0
                    b["rows"].append(v)
                    b["cols"].append(rid)
    for cname, b in bit_batches.items():
        f = idx.field(cname)
        row_keys = None
        rows = b["rows"]
        if any(isinstance(r, str) for r in rows):
            if not f.options.keys:
                raise APIError(
                    f"column {cname} does not accept strings", 400)
            row_keys, rows = [str(r) for r in rows], None
        col_keys, cids = _split_ids(idx, b["cols"])
        api.import_bits(stmt.table, cname,
                        rows if rows is not None else [],
                        cids if cids is not None else [],
                        row_keys=row_keys, col_keys=col_keys)
    for cname, b in val_batches.items():
        col_keys, cids = _split_ids(idx, b["cols"])
        api.import_values(stmt.table, cname,
                          cids if cids is not None else [],
                          b["values"], col_keys=col_keys)
    if not bit_batches and not val_batches:
        # records with only _id still exist (reference: existence field)
        ids = [row[id_pos] for row in stmt.rows]
        col_keys, cids = _split_ids(idx, ids)
        if col_keys is not None:
            created = api.create_index_keys(stmt.table, col_keys)
            cids = [created[k] for k in col_keys]
        # gate like api.import_bits does: an escalated exclusive snapshot
        # read must not race the existence-field mutation
        with idx.mutate_gate.shared():
            idx.mark_exists(np.asarray(cids, dtype=np.int64))
    return _ok()


def _split_ids(idx, ids):
    """-> (col_keys, col_ids): string ids go through key translation."""
    if any(isinstance(i, str) for i in ids):
        if not idx.options.keys:
            raise APIError("table does not use string _id", 400)
        return [str(i) for i in ids], None
    return None, [int(i) for i in ids]


def _bulk_insert(api: API, stmt: sa.BulkInsert) -> dict:
    """BULK INSERT ... FROM 'file.csv' (reference: sql3 BULK INSERT)."""
    import csv
    idx = api.holder.index(stmt.table)
    if idx is None:
        raise APIError(f"table not found: {stmt.table}", 404)
    if str(stmt.format).upper() != "CSV":
        raise APIError(f"unsupported BULK INSERT format {stmt.format}", 400)
    if stmt.inline:
        # FROM x'...' / INPUT 'STREAM': the source IS the data
        # (reference: defs_bulkinsert.go inline streams)
        lines = [ln.strip() for ln in stmt.source.splitlines()
                 if ln.strip()]
        rows = list(csv.reader(lines))
    else:
        try:
            fh = open(stmt.source, newline="")
        except OSError as e:
            raise APIError(f"cannot open {stmt.source}: {e}", 400)
        with fh:
            reader = csv.reader(fh)
            rows = list(reader)
    if not rows:
        return _ok()
    if stmt.map_spec is not None and stmt.columns:
        # MAP positions (+ optional TRANSFORM @refs) select source
        # fields per target column; MAP index N -> source position
        cols = stmt.columns
        refs = stmt.transform if stmt.transform is not None \
            else list(range(len(stmt.map_spec)))
        if len(refs) != len(cols):
            raise APIError(
                "BULK INSERT column list and transform/map arity differ",
                400)
        out_rows = []
        for r in rows:
            vals = []
            for ref in refs:
                if isinstance(ref, tuple):  # ("lit", v)
                    vals.append(ref[1])
                    continue
                if ref >= len(stmt.map_spec):
                    raise APIError(f"@{ref} out of MAP range", 400)
                pos = stmt.map_spec[ref][0]
                vals.append(r[pos].strip() if pos < len(r) else "")
            out_rows.append(vals)
        rows = out_rows
    elif stmt.columns:
        cols = stmt.columns
        if stmt.header:
            rows = rows[1:]
    elif stmt.header:
        cols, rows = rows[0], rows[1:]
    else:
        raise APIError("BULK INSERT needs a column list or header row", 400)

    def coerce(cname, v):
        if v == "":
            return None
        f = idx.field(cname)
        if cname == "_id":
            return int(v) if not idx.options.keys else v
        if f is not None and f.is_bsi():
            return float(v) if "." in v else int(v)
        if f is not None and f.options.type == "bool":
            return v.lower() in ("1", "true", "t")
        if f is not None and not f.options.keys:
            return int(v)
        return v

    data = [[coerce(c, v) for c, v in zip(cols, r)] for r in rows]
    return _insert(api, sa.Insert(stmt.table, list(cols), data))


def _delete(api: API, stmt: sa.Delete) -> dict:
    idx = api.holder.index(stmt.table)
    if idx is None:
        raise APIError(f"table not found: {stmt.table}", 404)
    if stmt.where is None:
        filt = Call("All")
    else:
        comp = SelectCompiler(api)
        # materialize IN (SELECT ...) subqueries first (reference:
        # defs_delete.go "delete ... where _id in (select ...)")
        shim = sa.Select()
        shim.where = stmt.where
        stmt.where = comp._rewrite_in_selects(shim).where
        filt, residual = comp.split_where(idx, stmt.table, stmt.where)
        if residual is not None:
            raise APIError("DELETE WHERE must be expressible as a bitmap "
                           "filter", 400)
        if filt is None:
            filt = Call("All")
    api.query(stmt.table, Query([Call("Delete", children=[filt])]))
    return _ok()


# -- PQL-backed operators -----------------------------------------------------------

class PlanOpPQLTableScan(PlanOp):
    """Extract()-backed scan (reference: oppqltablescan.go:24)."""

    def __init__(self, api: API, table: str, alias: str,
                 columns: List[str], filt: Optional[Call]):
        self.api = api
        self.table = table
        self.alias = alias or table
        self.columns = columns
        self.filt = filt or Call("All")

    def name(self):
        return f"PQLTableScan({self.table})"

    def run(self):
        idx = self.api.holder.index(self.table)
        ext = Call("Extract", children=[self.filt] +
                   [Call("Rows", {"_field": c}) for c in self.columns])
        (tbl,) = self.api.query(self.table, Query([ext]))
        id_type = "string" if idx.options.keys else "id"
        schema = [(f"{self.alias}._id", id_type)]
        fields = []
        for c in self.columns:
            f = idx.field(c)
            t = _FIELD_TO_SQL.get((f.options.type, f.options.keys),
                                  f.options.type)
            schema.append((f"{self.alias}.{c}", t))
            fields.append(f)
        rows = []
        for colrec in tbl.columns:
            row = [colrec.column]
            for fi, f in enumerate(fields):
                v = colrec.rows[fi]
                if f.options.type == "timestamp" and v is not None:
                    v = _ts_to_iso(v, f.options.time_unit)
                row.append(v)
            rows.append(row)
        return schema, rows


def _ts_to_iso(v, unit: str) -> str:
    secs = float(v) * _UNIT_SECONDS.get(unit or "s", 1.0)
    return datetime.datetime.fromtimestamp(
        secs, datetime.timezone.utc).replace(tzinfo=None).isoformat()


class PlanOpPQLAggregate(PlanOp):
    """Pure-aggregate pushdown: one PQL call per aggregate (reference:
    oppqlaggregate.go; planoptimizer.go:876)."""

    def __init__(self, api: API, table: str, aggs: List[sa.Func],
                 filt: Optional[Call]):
        self.api = api
        self.table = table
        self.aggs = aggs
        self.filt = filt

    def name(self):
        return f"PQLAggregate({self.table})"

    def run(self):
        calls = []
        for a in self.aggs:
            calls.append(_agg_to_call(a, self.filt))
        results = self.api.query(self.table, Query(calls))
        schema, row = [], []
        idx = self.api.holder.index(self.table)
        for a, r in zip(self.aggs, results):
            schema.append((agg_slot_name(a), _agg_result_type(idx, a)))
            row.append(_agg_result_value(a, r))
        return schema, [row]


def _agg_result_type(idx, a: sa.Func) -> str:
    """Result type of a pushed-down aggregate: value-typed aggregates
    carry the field's type (reference: percentileTests ExpHdrs
    fldTypeDecimal2 for decimal fields); counts stay int."""
    if a.name in ("count", "var", "corr"):
        return "int" if a.name == "count" else "decimal(6)"
    if a.name == "avg":
        return "decimal(6)"
    col = a.args[0].name if a.args and isinstance(a.args[0], sa.Col) \
        else None
    f = idx.field(col) if idx is not None and col else None
    if f is not None:
        t = f.options.type
        if t == "decimal":
            return f"decimal({f.options.scale})"
        if t == "timestamp":
            return "timestamp"
    return "int"


def _agg_to_call(a: sa.Func, filt: Optional[Call]) -> Call:
    kids = [filt] if filt is not None else []
    col = a.args[0].name if a.args and isinstance(a.args[0], sa.Col) else None
    if a.name == "count":
        if a.distinct and col:
            return Call("Count", children=[
                Call("Distinct", {"_field": col}, children=list(kids))])
        if col:
            # COUNT(col) counts rows where col is not null
            notnull = Call("Row", {col: Condition("!=", None)})
            inner = Call("Intersect", children=[notnull] + kids) if kids \
                else notnull
            return Call("Count", children=[inner])
        return Call("Count", children=kids or [Call("All")])
    if a.name in ("sum", "avg"):
        return Call("Sum", {"_field": col}, children=list(kids))
    if a.name == "min":
        return Call("Min", {"_field": col}, children=list(kids))
    if a.name == "max":
        return Call("Max", {"_field": col}, children=list(kids))
    if a.name == "percentile":
        nth = a.args[1].value if len(a.args) > 1 else 50
        args = {"_field": col, "nth": nth}
        if filt is not None:
            args["filter"] = filt
        return Call("Percentile", args)
    if a.name == "var":
        args = {"_field": col}
        if filt is not None:
            args["filter"] = filt
        return Call("Var", args)
    if a.name == "corr":
        args = {"_field": col, "field2": a.args[1].name}
        if filt is not None:
            args["filter"] = filt
        return Call("Corr", args)
    raise SQLRuntimeError(f"cannot push down aggregate {a.name}")


def _agg_result_value(a: sa.Func, r):
    if a.name == "count":
        return int(r)
    if r is None:
        return None
    if a.name in ("var", "corr"):
        return r  # already a rounded float (executor Var/Corr)
    if a.name == "avg":
        return r.val / r.count if r.count else None
    if r.float_val is not None:
        return r.float_val
    return r.val


class PlanOpPQLGroupBy(PlanOp):
    """GroupBy pushdown (reference: oppqlmultigroupby.go;
    planoptimizer.go:661)."""

    def __init__(self, api: API, table: str, group_cols: List[str],
                 aggs: List[sa.Func], filt: Optional[Call], alias: str):
        self.api = api
        self.table = table
        self.alias = alias or table
        self.group_cols = group_cols
        self.aggs = aggs
        self.filt = filt

    def name(self):
        return f"PQLGroupBy({self.table})"

    def run(self):
        args: Dict[str, Any] = {}
        for a in self.aggs:
            if a.name in ("sum", "avg"):
                args["aggregate"] = Call("Sum", {"_field": a.args[0].name})
        if self.filt is not None:
            args["filter"] = self.filt
        gb = Call("GroupBy", args,
                  children=[Call("Rows", {"_field": g})
                            for g in self.group_cols])
        (groups,) = self.api.query(self.table, Query([gb]))
        schema = [(f"{self.alias}.{g}", "") for g in self.group_cols] + \
            [(agg_slot_name(a), "int") for a in self.aggs]
        rows = []
        for gc in groups:
            key = [fr.row_key if fr.row_key is not None else fr.row_id
                   for fr in gc.group]
            vals = []
            for a in self.aggs:
                if a.name == "count":
                    vals.append(gc.count)
                elif a.name == "sum":
                    vals.append(gc.decimal_agg if gc.decimal_agg is not None
                                else gc.agg)
                elif a.name == "avg":
                    agg = gc.decimal_agg if gc.decimal_agg is not None \
                        else gc.agg
                    vals.append(agg / gc.count if gc.count else None)
            rows.append(key + vals)
        return schema, rows


class PlanOpSystemTable(PlanOp):
    def __init__(self, api: API, table: str, alias: str):
        self.api = api
        self.table = table
        self.alias = alias or table

    def name(self):
        return f"SystemTable({self.table})"

    def run(self):
        schema, rows = run_system_table(self.api, self.table)
        return [(f"{self.alias}.{n}", t) for n, t in schema], rows


class PlanOpTableValuedFunction(PlanOp):
    """FROM-clause function call (reference: optablevaluedfunction.go —
    the sql3 planner plans these but its Iterator returns 'not yet
    implemented'; here they execute).  Registry below; each entry maps
    arg values -> (schema, rows)."""

    def __init__(self, fn_name: str, arg_values: list, alias: str):
        self.fn_name = fn_name.lower()
        self.arg_values = arg_values
        self.alias = alias or fn_name

    def name(self):
        return f"TableValuedFunction({self.fn_name})"

    def _materialize(self):
        if not hasattr(self, "_result"):
            fn = _TVF_REGISTRY.get(self.fn_name)
            if fn is None:
                raise APIError(
                    f"unknown table-valued function: {self.fn_name}", 400)
            self._result = fn(self.arg_values)
        return self._result

    def run(self):
        schema, rows = self._materialize()
        return [(f"{self.alias}.{n}", t) for n, t in schema], rows


def _tvf_generate_series(args: list):
    """generate_series(start, stop[, step]) -> one INT column `value`
    (inclusive bounds, postgres-style)."""
    if len(args) not in (2, 3):
        raise APIError("generate_series(start, stop[, step])", 400)
    try:
        start, stop = int(args[0]), int(args[1])
        step = int(args[2]) if len(args) == 3 else 1
    except (TypeError, ValueError):
        raise APIError("generate_series() arguments must be integers", 400)
    if step == 0:
        raise APIError("generate_series() step must not be zero", 400)
    out = []
    v = start
    if step > 0:
        while v <= stop:
            out.append([v])
            v += step
    else:
        while v >= stop:
            out.append([v])
            v += step
    if len(out) > 10_000_000:
        raise APIError("generate_series() result too large", 400)
    return [("value", "int")], out


def _tvf_split_string(args: list):
    """split_string(text, sep) -> STRING column `value`, one row per
    part (SQL Server STRING_SPLIT analog)."""
    if len(args) != 2:
        raise APIError("split_string(text, separator)", 400)
    text, sep = str(args[0]), str(args[1])
    if sep == "":
        raise APIError("split_string() separator must not be empty", 400)
    return [("value", "string")], [[part] for part in text.split(sep)]


_TVF_REGISTRY = {
    "generate_series": _tvf_generate_series,
    "split_string": _tvf_split_string,
}


class PlanOpPQLDistinctScan(PlanOp):
    """SELECT DISTINCT col pushdown (reference: oppqldistinctscan.go;
    planoptimizer.go:753)."""

    def __init__(self, api: API, table: str, column: str,
                 filt: Optional[Call], alias: str):
        self.api = api
        self.table = table
        self.column = column
        self.filt = filt
        self.alias = alias or table

    def name(self):
        return f"PQLDistinctScan({self.table}.{self.column})"

    def run(self):
        idx = self.api.holder.index(self.table)
        f = idx.field(self.column)
        call = Call("Distinct", {"_field": self.column},
                    children=[self.filt] if self.filt is not None else [])
        (res,) = self.api.query(self.table, Query([call]))
        t = _FIELD_TO_SQL.get((f.options.type, f.options.keys),
                              f.options.type)
        schema = [(f"{self.alias}.{self.column}",
                   t.replace("[]", "").replace("idset", "id")
                   .replace("stringset", "string"))]
        from featurebase_tpu_torch.model.row import Row, SignedRow
        rows = []
        if isinstance(res, SignedRow):
            for v in res.values():
                rows.append([f.decode_value(int(v)) if f.is_bsi() else int(v)])
        elif isinstance(res, Row):
            if res.keys is not None and f.options.keys:
                rows = [[k] for k in res.keys]
            else:
                ids = [int(c) for c in res.columns()]
                if f.options.keys:
                    store = idx.row_translation(self.column)
                    rows = [[store.translate_ids([i])[0]] for i in ids]
                else:
                    rows = [[i] for i in ids]
        return schema, rows


# -- SELECT compiler ------------------------------------------------------------------

class SelectCompiler:
    def __init__(self, api: API, depth: int = 0):
        self.api = api
        self.depth = depth
        if depth > 8:
            raise APIError("view/subquery nesting too deep", 400)

    # -- entry ---------------------------------------------------------------

    def compile(self, sel: sa.Select) -> PlanOp:
        sel = self._rewrite_in_selects(sel)
        aggs = self._collect_aggs(sel)

        # sources
        if sel.table is None:
            src: PlanOp = PlanOpStatic([], [[]])
            src_info = None
        else:
            src, src_info = self._compile_source(sel.table,
                                                 allow_scan_defer=True)
        join_srcs = [(j, *self._compile_source(j.table,
                                               allow_scan_defer=True))
                     for j in sel.joins]
        self._validate_columns(sel, src, src_info, join_srcs)
        if src_info is not None:
            for a in aggs:
                self._validate_agg(src_info["table"], a)
            # set-typed columns have no total order (reference:
            # defs_orderby.go "unable to sort a column of type ...")
            idx0 = self.api.holder.index(src_info["table"])
            if idx0 is not None and sel.order_by:
                amap = {it.alias: it.expr for it in sel.items if it.alias}
                # a set column in GROUP BY projects one scalar member per
                # group — sortable (reference: defs_groupby.go groups by
                # idset and orders on it)
                grouped = {g.name for g in sel.group_by
                           if isinstance(g, sa.Col)}
                for e, _ in sel.order_by:
                    t = amap.get(e.name, e) \
                        if isinstance(e, sa.Col) and e.table is None else e
                    if isinstance(t, sa.Col) and t.name not in grouped:
                        f0 = idx0.field(t.name)
                        if f0 is not None and \
                                f0.options.type in ("set", "time"):
                            kind = "stringset" if f0.options.keys \
                                else "idset"
                            raise APIError(
                                "unable to sort a column of type "
                                f"'{kind}'", 400)

        joins_present = bool(sel.joins)

        # WHERE pushdown (single real-table scans only; reference
        # planoptimizer.go:501 filter pushdown)
        residual = sel.where
        filt_call: Optional[Call] = None
        if src_info is not None and not joins_present:
            idx = self.api.holder.index(src_info["table"])
            if sel.where is not None:
                filt_call, residual = self.split_where(
                    idx, src_info["alias"], sel.where)

        # ---- fast path: DISTINCT single column, no joins/aggregates
        if (src_info is not None and not joins_present and sel.distinct
                and not aggs and not sel.group_by
                and len(sel.items) == 1
                and isinstance(sel.items[0].expr, sa.Col)
                and residual is None
                and sel.items[0].expr.name != "_id"):
            colname = sel.items[0].expr.name
            idx = self.api.holder.index(src_info["table"])
            if idx.field(colname) is not None and \
                    idx.field(colname).options.type != "time":
                op: PlanOp = PlanOpPQLDistinctScan(
                    self.api, src_info["table"], colname, filt_call,
                    src_info["alias"])
                op = self._finalize(sel, op, aggs, distinct_done=True)
                return op

        # ---- fast path: pure aggregates, all pushable
        if (src_info is not None and not joins_present and aggs
                and not sel.group_by and residual is None
                and all(self._agg_pushable(src_info["table"], a)
                        for a in aggs)
                and all(self._is_agg_only_item(it, aggs)
                        for it in sel.items)):
            op = PlanOpPQLAggregate(self.api, src_info["table"], aggs,
                                    filt_call)
            return self._finalize(sel, op, aggs)

        # ---- fast path: GROUP BY pushdown
        if (src_info is not None and not joins_present and sel.group_by
                and residual is None
                and self._groupby_pushable(src_info["table"], sel, aggs)):
            cols = [g.name for g in sel.group_by]
            op = PlanOpPQLGroupBy(self.api, src_info["table"], cols, aggs,
                                  filt_call, src_info["alias"])
            return self._finalize(sel, op, aggs, grouped=True)

        # ---- general path: scan -> residual filter -> joins -> group -> ...
        if src_info is not None:
            cols_needed = self._referenced_columns(sel, src_info)
            src = PlanOpPQLTableScan(self.api, src_info["table"],
                                     src_info["alias"], cols_needed,
                                     filt_call)
        op = src
        for j, right, rinfo in join_srcs:
            if rinfo is not None:
                rcols = self._referenced_columns(sel, rinfo)
                right = PlanOpPQLTableScan(self.api, rinfo["table"],
                                           rinfo["alias"], rcols, None)
            op = PlanOpNestedLoops(op, right, j.kind, j.on)
        if residual is not None:
            op = PlanOpFilter(op, residual)
        if sel.group_by or aggs:
            op = PlanOpGroupBy(op, sel.group_by, aggs)
            return self._finalize(sel, op, aggs, grouped=True)
        return self._finalize(sel, op, aggs)

    # -- binder: column validation (reference: analyzePlan type-check/bind,
    # executionplanner.go:137) --------------------------------------------------

    def _validate_columns(self, sel: sa.Select, src, src_info,
                          join_srcs=()):
        qualified: set = set()
        bare: set = set()

        def add_source(op, info, alias_hint=None):
            if info is not None:
                idx = self.api.holder.index(info["table"])
                alias = info["alias"]
                for n in ["_id"] + [f.name for f in idx.public_fields()]:
                    qualified.add((alias, n))
                    bare.add(n)
            elif op is not None:
                for name, _ in self._schema_of(op):
                    if name.startswith("$agg:"):
                        continue
                    if "." in name:
                        a, n = name.split(".", 1)
                        qualified.add((a, n))
                        bare.add(n)
                    else:
                        bare.add(name)

        add_source(src, src_info)
        for _, jop, jinfo in join_srcs:
            add_source(jop, jinfo)
        aliases = {it.alias for it in sel.items if it.alias}

        def check(e):
            if e is None or isinstance(e, (sa.Lit, sa.Star)):
                return
            if isinstance(e, sa.Col):
                if e.table is not None:
                    if (e.table, e.name) not in qualified:
                        raise APIError(
                            f"column not found: {e.table}.{e.name}", 400)
                elif e.name not in bare and e.name not in aliases:
                    raise APIError(f"column not found: {e.name}", 400)
                return
            if isinstance(e, sa.BinOp):
                check(e.left)
                check(e.right)
            elif isinstance(e, sa.UnOp):
                check(e.operand)
            elif isinstance(e, sa.Func):
                for a in e.args:
                    check(a)
            elif isinstance(e, sa.Case):
                check(e.operand)
                for c, r in e.whens:
                    check(c)
                    check(r)
                check(e.else_)
            elif isinstance(e, sa.InList):
                check(e.expr)
                for v in e.values:
                    check(v)
            elif isinstance(e, sa.Between):
                check(e.expr)
                check(e.lo)
                check(e.hi)
            elif isinstance(e, (sa.IsNull, sa.Like)):
                check(e.expr)

        for it in sel.items:
            check(it.expr)
        check(sel.where)
        check(sel.having)
        for g in sel.group_by:
            check(g)
        for e, _ in sel.order_by:
            check(e)
        for j in sel.joins:
            check(j.on)

    # -- finalize: having / projection / distinct / order / top ----------------

    def _finalize(self, sel: sa.Select, op: PlanOp, aggs: List[sa.Func],
                  grouped: bool = False, distinct_done: bool = False
                  ) -> PlanOp:
        if sel.having is not None:
            op = PlanOpFilter(op, sel.having)

        # ORDER BY runs pre-projection so it can reference scan columns;
        # aliases are resolved to their defining expressions
        if sel.order_by:
            alias_map = {it.alias: it.expr for it in sel.items if it.alias}
            keys = []
            items = [it for it in sel.items]
            for e, desc in sel.order_by:
                if isinstance(e, sa.Lit) and isinstance(e.value, int):
                    # ordinal: ORDER BY 1 = first select item (reference:
                    # defs_orderby.go / defs_groupby.go "order by 2 asc")
                    n = e.value
                    if not 1 <= n <= len(items) or \
                            isinstance(items[n - 1].expr, sa.Star):
                        raise APIError(
                            f"ORDER BY position {n} is out of range", 400)
                    target = items[n - 1].expr
                elif isinstance(e, sa.Col) and e.table is None:
                    target = alias_map.get(e.name, e)
                else:
                    target = e
                keys.append((self._key_fn(target), desc))
            op = PlanOpOrderBy(op, keys)

        items = self._expand_items(sel, op)
        op = PlanOpProjection(op, items)
        if sel.distinct and not distinct_done:
            op = PlanOpDistinct(op)
        if sel.limit is not None or sel.offset:
            op = PlanOpTop(op, sel.limit, sel.offset)
        return op

    @staticmethod
    def _key_fn(expr: sa.Expr):
        def fn(schema, row):
            return eval_expr(expr, make_env(schema, row))
        return fn

    def _expand_items(self, sel: sa.Select, op: PlanOp
                      ) -> List[Tuple[str, str, sa.Expr]]:
        """SelectItem list -> (name, type, expr) triples; Star expands to the
        child schema (bare names)."""
        # probing the child schema requires knowing it without running; all
        # our ops expose schema only via run(), so for Star we inspect the
        # source ops structurally
        items: List[Tuple[str, str, sa.Expr]] = []
        for it in sel.items:
            if isinstance(it.expr, sa.Star):
                want_tbl = it.expr.table
                for name, t in self._schema_of(op):
                    if name.startswith("$agg:"):
                        continue
                    tbl = name.split(".", 1)[0] if "." in name else None
                    if want_tbl is not None and tbl != want_tbl:
                        continue  # qualified star: u.* (defs_join.go)
                    bare = name.split(".", 1)[1] if "." in name else name
                    items.append((bare, t, sa.Col(name)))
                continue
            name = it.alias or repr_expr(it.expr)
            t = self._type_of(it.expr, op)
            items.append((name, t, it.expr))
        return items

    def _schema_of(self, op: PlanOp) -> List[Tuple[str, str]]:
        if isinstance(op, PlanOpTableValuedFunction):
            try:
                schema, _ = op._materialize()
            except APIError:
                return []
            return [(f"{op.alias}.{n}", t) for n, t in schema]
        if isinstance(op, PlanOpPQLTableScan):
            idx = self.api.holder.index(op.table)
            out = [(f"{op.alias}._id",
                    "string" if idx.options.keys else "id")]
            for c in op.columns:
                f = idx.field(c)
                out.append((f"{op.alias}.{c}",
                            _FIELD_TO_SQL.get((f.options.type,
                                               f.options.keys),
                                              f.options.type)))
            return out
        if isinstance(op, PlanOpSystemTable):
            schema, _ = run_system_table(self.api, op.table)
            return [(f"{op.alias}.{n}", t) for n, t in schema]
        if isinstance(op, PlanOpPQLDistinctScan):
            schema, _ = op.run()  # cheap: distinct values only
            return schema
        if isinstance(op, PlanOpPQLGroupBy):
            return [(f"{op.alias}.{g}", "") for g in op.group_cols] + \
                [(agg_slot_name(a), "int") for a in op.aggs]
        if isinstance(op, PlanOpPQLAggregate):
            idx = self.api.holder.index(op.table)
            return [(agg_slot_name(a), _agg_result_type(idx, a))
                    for a in op.aggs]
        if isinstance(op, PlanOpGroupBy):
            return [(repr_expr(g), "") for g in op.group_exprs] + \
                [(agg_slot_name(a), "") for a in op.aggs]
        if isinstance(op, (PlanOpFilter, PlanOpOrderBy, PlanOpTop,
                           PlanOpDistinct)):
            return self._schema_of(op.children()[0])
        if isinstance(op, PlanOpNestedLoops):
            return self._schema_of(op.left) + self._schema_of(op.right)
        if isinstance(op, PlanOpProjection):
            return [(n, t) for n, t, _ in op.items]
        if isinstance(op, PlanOpStatic):
            return op.schema
        if isinstance(op, _QualifyOp):
            return [(f"{op.alias}.{n.split('.', 1)[1] if '.' in n else n}", t)
                    for n, t in self._schema_of(op.child)]
        return []

    def _type_of(self, e: sa.Expr, op: PlanOp) -> str:
        if isinstance(e, sa.Col):
            want = f"{e.table}.{e.name}" if e.table else e.name
            for name, t in self._schema_of(op):
                bare = name.split(".", 1)[1] if "." in name else name
                if name == want or bare == want:
                    return t
            return ""
        if isinstance(e, sa.Func) and e.name in sa.AGGREGATES:
            # value-typed aggregates carry the field's type through the
            # $agg slot (reference: percentileTests ExpHdrs
            # fldTypeDecimal2); the child op schema knows it
            slot = agg_slot_name(e)
            for name, t in self._schema_of(op):
                if name == slot and t:
                    return t
            if e.name in ("avg", "var", "corr"):
                return "decimal"
            return "int"
        if isinstance(e, sa.Lit):
            if isinstance(e.value, bool):
                return "bool"
            if isinstance(e.value, int):
                return "int"
            if isinstance(e.value, float):
                return "decimal"
            return "string"
        return ""

    # -- sources -----------------------------------------------------------------

    def _compile_source(self, ref: sa.TableRef, allow_scan_defer=False
                        ) -> Tuple[Optional[PlanOp], Optional[dict]]:
        if ref.subquery is not None:
            inner = SelectCompiler(self.api, self.depth + 1) \
                .compile(ref.subquery)
            op = _QualifyOp(inner, ref.alias)
            return op, None
        name = ref.name
        if ref.fn_args is not None:
            vals = [eval_expr(a, {}) for a in ref.fn_args]
            return PlanOpTableValuedFunction(name, vals, ref.alias), None
        if is_system_table(name):
            return PlanOpSystemTable(self.api, name, ref.alias), None
        views = getattr(self.api.holder, "sql_views", {})
        if name in views:
            sub = parse_sql(views[name])[0]
            if not isinstance(sub, sa.Select):
                raise APIError(f"view {name} is not a SELECT", 400)
            inner = SelectCompiler(self.api, self.depth + 1).compile(sub)
            return _QualifyOp(inner, ref.alias), None
        idx = self.api.holder.index(name)
        if idx is None:
            raise APIError(f"table not found: {name}", 404)
        info = {"table": name, "alias": ref.alias or name}
        if allow_scan_defer:
            return None, info
        return PlanOpPQLTableScan(self.api, name, info["alias"],
                                  [f.name for f in idx.public_fields()],
                                  None), None

    def _referenced_columns(self, sel: sa.Select, info: dict) -> List[str]:
        idx = self.api.holder.index(info["table"])
        field_names = {f.name for f in idx.public_fields()}
        alias = info["alias"]
        refs: set = set()
        star = [False]

        def walk(e):
            if e is None:
                return
            if isinstance(e, sa.Star):
                star[0] = True
            elif isinstance(e, sa.Col):
                if e.table in (None, alias, info["table"]) and \
                        e.name in field_names:
                    refs.add(e.name)
            elif isinstance(e, sa.BinOp):
                walk(e.left)
                walk(e.right)
            elif isinstance(e, sa.UnOp):
                walk(e.operand)
            elif isinstance(e, sa.Func):
                for a in e.args:
                    walk(a)
            elif isinstance(e, sa.Case):
                walk(e.operand)
                for c, r in e.whens:
                    walk(c)
                    walk(r)
                walk(e.else_)
            elif isinstance(e, sa.InList):
                walk(e.expr)
                for v in e.values:
                    walk(v)
            elif isinstance(e, (sa.Between,)):
                walk(e.expr)
                walk(e.lo)
                walk(e.hi)
            elif isinstance(e, (sa.IsNull, sa.Like)):
                walk(e.expr)

        for it in sel.items:
            walk(it.expr)
        walk(sel.where)
        walk(sel.having)
        for g in sel.group_by:
            walk(g)
        for e, _ in sel.order_by:
            walk(e)
        for j in sel.joins:
            walk(j.on)
        if star[0]:
            return [f.name for f in idx.public_fields()]
        return sorted(refs)

    # -- aggregates ---------------------------------------------------------------

    def _collect_aggs(self, sel: sa.Select) -> List[sa.Func]:
        found: List[sa.Func] = []
        seen = set()

        def walk(e):
            if isinstance(e, sa.Func):
                if e.name in sa.AGGREGATES:
                    key = agg_slot_name(e)
                    if key not in seen:
                        seen.add(key)
                        found.append(e)
                    return
                for a in e.args:
                    walk(a)
            elif isinstance(e, sa.BinOp):
                walk(e.left)
                walk(e.right)
            elif isinstance(e, sa.UnOp):
                walk(e.operand)
            elif isinstance(e, sa.Case):
                for c, r in e.whens:
                    walk(c)
                    walk(r)
                if e.else_ is not None:
                    walk(e.else_)

        for it in sel.items:
            if not isinstance(it.expr, sa.Star):
                walk(it.expr)
        if sel.having is not None:
            walk(sel.having)
        for e, _ in sel.order_by:
            walk(e)
        return found

    def _validate_agg(self, table: str, a: sa.Func):
        """Aggregate argument typing (reference: sql3 semantic checks,
        defs_aggregate.go percentileTests error shapes)."""
        idx = self.api.holder.index(table)
        if idx is None or a.name != "percentile":
            return
        if not a.args or not isinstance(a.args[0], sa.Col):
            raise APIError(
                "percentile: column reference expected", 400)
        col = a.args[0].name
        if col == "_id":
            raise APIError(
                "_id column cannot be used in aggregate function "
                "'percentile'", 400)
        f = idx.field(col)
        if f is not None and not f.is_bsi():
            raise APIError(
                "percentile: integer, decimal or timestamp expression "
                "expected", 400)
        if len(a.args) > 1 and not isinstance(a.args[1], sa.Lit):
            raise APIError("percentile: literal expression expected", 400)

    def _agg_pushable(self, table: str, a: sa.Func) -> bool:
        idx = self.api.holder.index(table)
        if a.name == "count":
            if not a.args or isinstance(a.args[0], sa.Star):
                return not a.distinct
            col = a.args[0]
            return isinstance(col, sa.Col) and idx.field(col.name) is not None
        if a.name in ("sum", "min", "max", "avg", "percentile", "var"):
            if not a.args or not isinstance(a.args[0], sa.Col):
                return False
            if a.distinct:
                return False
            if a.name == "var" and self.api.cluster is not None:
                return False  # local fused program only; see corr below
            f = idx.field(a.args[0].name)
            return f is not None and f.is_bsi()
        if a.name == "corr":
            # fused BSI dot-product program (executor._execute_corr);
            # local-only — clustered plans aggregate at the coordinator
            # like the reference (expressionagg.go:950)
            if len(a.args) != 2 or a.distinct or self.api.cluster is not None:
                return False
            fs = [idx.field(x.name) if isinstance(x, sa.Col) else None
                  for x in a.args]
            return all(f is not None and f.is_bsi() for f in fs)
        return False

    def _is_agg_only_item(self, it: sa.SelectItem, aggs) -> bool:
        """Item evaluable from aggregate slots alone (no raw columns)."""
        def ok(e):
            if isinstance(e, sa.Func) and e.name in sa.AGGREGATES:
                return True
            if isinstance(e, sa.Lit):
                return True
            if isinstance(e, sa.BinOp):
                return ok(e.left) and ok(e.right)
            if isinstance(e, sa.UnOp):
                return ok(e.operand)
            if isinstance(e, sa.Func):
                return all(ok(a) for a in e.args)
            return False
        return not isinstance(it.expr, sa.Star) and ok(it.expr)

    def _groupby_pushable(self, table: str, sel: sa.Select,
                          aggs: List[sa.Func]) -> bool:
        idx = self.api.holder.index(table)
        for g in sel.group_by:
            if not isinstance(g, sa.Col):
                return False
            f = idx.field(g.name)
            if f is None or f.options.type not in ("set", "mutex", "bool"):
                return False
        sums = 0
        for a in aggs:
            if a.name == "count" and (not a.args or
                                      isinstance(a.args[0], sa.Star)) \
                    and not a.distinct:
                continue
            if a.name in ("sum", "avg") and a.args and \
                    isinstance(a.args[0], sa.Col) and not a.distinct:
                f = idx.field(a.args[0].name)
                if f is not None and f.is_bsi():
                    sums += 1
                    continue
            return False
        if sums > 1:
            return False
        # items must reference only group cols / aggregates
        group_names = {g.name for g in sel.group_by}

        def ok(e):
            if isinstance(e, sa.Col):
                return e.name in group_names
            if isinstance(e, sa.Func) and e.name in sa.AGGREGATES:
                return True
            if isinstance(e, sa.Lit):
                return True
            if isinstance(e, sa.BinOp):
                return ok(e.left) and ok(e.right)
            return False
        return all(not isinstance(it.expr, sa.Star) and ok(it.expr)
                   for it in sel.items)

    # -- IN (SELECT) rewrite --------------------------------------------------------

    def _rewrite_in_selects(self, sel: sa.Select) -> sa.Select:
        def rw(e):
            if isinstance(e, sa.InSelect):
                inner = SelectCompiler(self.api, self.depth + 1) \
                    .compile(e.select)
                schema, rows = inner.run()
                if schema and len(schema) != 1:
                    raise APIError("IN (SELECT) must return one column", 400)
                vals = [sa.Lit(r[0]) for r in rows]
                return sa.InList(e.expr, vals, e.negated)
            if isinstance(e, sa.ScalarSubquery):
                inner = SelectCompiler(self.api, self.depth + 1) \
                    .compile(e.select)
                schema, rows = inner.run()
                if schema and len(schema) != 1:
                    raise APIError("scalar subquery must return one column",
                                   400)
                if len(rows) > 1:
                    raise APIError("scalar subquery returned >1 row", 400)
                return sa.Lit(rows[0][0] if rows else None)
            if isinstance(e, sa.BinOp):
                e.left, e.right = rw(e.left), rw(e.right)
            elif isinstance(e, sa.UnOp):
                e.operand = rw(e.operand)
            elif isinstance(e, sa.InList):
                e.expr = rw(e.expr)
                e.values = [rw(v) for v in e.values]
            elif isinstance(e, (sa.Between,)):
                e.expr = rw(e.expr)
                e.lo, e.hi = rw(e.lo), rw(e.hi)
            elif isinstance(e, (sa.IsNull, sa.Like)):
                e.expr = rw(e.expr)
            elif isinstance(e, sa.Func):
                e.args = [rw(a) for a in e.args]
            elif isinstance(e, sa.Case):
                if e.operand is not None:
                    e.operand = rw(e.operand)
                e.whens = [(rw(c), rw(r)) for c, r in e.whens]
                if e.else_ is not None:
                    e.else_ = rw(e.else_)
            return e

        if sel.where is not None:
            sel.where = rw(sel.where)
        if sel.having is not None:
            sel.having = rw(sel.having)
        return sel

    # -- WHERE pushdown ----------------------------------------------------------------

    def split_where(self, idx, alias: str, e: sa.Expr
                    ) -> Tuple[Optional[Call], Optional[sa.Expr]]:
        """-> (pql_filter, residual_expr); either may be None (reference:
        planoptimizer.go:501 filter pushdown)."""
        call = self._to_call(idx, alias, e)
        if call is not None:
            return call, None
        if isinstance(e, sa.BinOp) and e.op == "and":
            lc, lr = self.split_where(idx, alias, e.left)
            rc, rr = self.split_where(idx, alias, e.right)
            calls = [c for c in (lc, rc) if c is not None]
            call = calls[0] if len(calls) == 1 else \
                (Call("Intersect", children=calls) if calls else None)
            if lr is not None and rr is not None:
                residual: Optional[sa.Expr] = sa.BinOp("and", lr, rr)
            else:
                residual = lr if lr is not None else rr
            return call, residual
        return None, e

    def _to_call(self, idx, alias: str, e: sa.Expr) -> Optional[Call]:
        """Full expression -> PQL bitmap call, or None if not pushable."""
        if isinstance(e, sa.BinOp) and e.op == "and":
            l = self._to_call(idx, alias, e.left)
            r = self._to_call(idx, alias, e.right)
            if l is not None and r is not None:
                return Call("Intersect", children=[l, r])
            return None
        if isinstance(e, sa.BinOp) and e.op == "or":
            l = self._to_call(idx, alias, e.left)
            r = self._to_call(idx, alias, e.right)
            if l is not None and r is not None:
                return Call("Union", children=[l, r])
            return None
        if isinstance(e, sa.UnOp) and e.op == "not":
            c = self._to_call(idx, alias, e.operand)
            return Call("Not", children=[c]) if c is not None else None
        if isinstance(e, sa.Func) and e.name.lower() == "rangeq":
            # rangeq(col, from[, to]) -> Rows(field, from, to) filter
            # (reference: expressionpql.go RANGEQ; null bound = open end)
            if not e.args or not isinstance(e.args[0], sa.Col):
                return None
            col = e.args[0].name
            f = idx.field(col)
            if f is None:
                return None

            def bound(i):
                if len(e.args) <= i:
                    return None
                a = e.args[i]
                return a.value if isinstance(a, sa.Lit) else None
            frm, to = bound(1), bound(2)
            if frm is None and to is None:
                # user-facing 400 (reference: 'from' and 'to' cannot both
                # be null, defs_timequantum.go)
                raise APIError(
                    "rangeq: from and to cannot both be null", 400)
            args = {"_field": col}
            if frm is not None:
                args["from"] = frm
            if to is not None:
                args["to"] = to
            return Call("Rows", args)
        col, lit = _col_lit(e, alias)
        if col is None:
            return None
        if col == "_id":
            def bounded(c):
                # ConstRow alone would resurrect deleted records: bound
                # it by existence (reference: deleted ids stay gone,
                # defs_delete.go; found by tranche-4 acceptance)
                if idx.options.track_existence:
                    return Call("Intersect", children=[c, Call("All")])
                return c
            if isinstance(e, sa.BinOp) and e.op == "=":
                return bounded(
                    Call("ConstRow", {"columns": [self._id_of(idx, lit)]}))
            if isinstance(e, sa.BinOp) and e.op == "!=":
                return Call("Not", children=[
                    Call("ConstRow", {"columns": [self._id_of(idx, lit)]})])
            if isinstance(e, sa.InList) and not e.negated:
                vals = [self._id_of(idx, v.value) for v in e.values
                        if isinstance(v, sa.Lit)]
                if len(vals) == len(e.values):
                    return bounded(Call("ConstRow", {"columns": vals}))
            return None
        f = idx.field(col)
        if f is None:
            return None
        if isinstance(e, sa.BinOp):
            v = lit
            if f.is_bsi():
                op = {"=": "=="}.get(e.op, e.op)
                return Call("Row", {col: Condition(op, v)})
            if f.options.type == "bool":
                v = 1 if v in (True, 1, "true") else 0
            if isinstance(v, bool):
                return None
            if e.op == "=":
                return Call("Row", {col: v})
            if e.op == "!=":
                # SQL: NULL != v is NULL (filtered out), so restrict the
                # complement to records that have some value in the field
                return self._and_not_null(col, Call(
                    "Not", children=[Call("Row", {col: v})]))
            return None
        if isinstance(e, sa.Between) and f.is_bsi() and not e.negated:
            if isinstance(e.lo, sa.Lit) and isinstance(e.hi, sa.Lit):
                return Call("Row", {col: Condition("betw",
                                                   [e.lo.value, e.hi.value])})
            return None
        if isinstance(e, sa.InList):
            vals = [v.value for v in e.values if isinstance(v, sa.Lit)]
            if len(vals) != len(e.values):
                return None
            if f.is_bsi():
                inner = Call("Union", children=[
                    Call("Row", {col: Condition("==", v)}) for v in vals])
            else:
                if f.options.type == "bool":
                    vals = [1 if v in (True, 1, "true") else 0 for v in vals]
                if any(isinstance(v, bool) for v in vals):
                    return None
                inner = Call("Union", children=[Call("Row", {col: v})
                                                for v in vals])
            if e.negated:
                if f.is_bsi():
                    # BSI not-null is a Condition row, not Rows()
                    # (row ids of a BSI view are bit planes)
                    notnull = Call("Row", {col: Condition("!=", None)})
                    return Call("Intersect", children=[
                        Call("Not", children=[inner]), notnull])
                return self._and_not_null(
                    col, Call("Not", children=[inner]))
            return inner
        if isinstance(e, sa.IsNull) and f.is_bsi():
            cond = Condition("!=" if e.negated else "==", None)
            return Call("Row", {col: cond})
        return None

    def _and_not_null(self, col: str, call: Call) -> Call:
        """NULL-correct negation on set-like fields: restrict a Not()
        complement to records holding any value in the field (SQL
        three-valued logic filters NULL rows out of != / NOT IN)."""
        notnull = Call("UnionRows",
                       children=[Call("Rows", {"_field": col})])
        return Call("Intersect", children=[call, notnull])

    def _id_of(self, idx, v):
        if isinstance(v, str):
            # cluster replication keeps every node's store complete, so a
            # local lookup is authoritative on the coordinator too
            return idx.translate_store.find_keys([v]).get(v, -1)
        return int(v)


def _col_lit(e: sa.Expr, alias: str):
    """(col_name, literal) for a leaf predicate whose lhs is a column of this
    table and rhs a literal; (None, None) otherwise."""
    def colname(c):
        if isinstance(c, sa.Col) and c.table in (None, alias):
            return c.name
        return None
    if isinstance(e, sa.BinOp) and e.op in ("=", "!=", "<", "<=", ">", ">="):
        c = colname(e.left)
        if c is not None and isinstance(e.right, sa.Lit):
            return c, e.right.value
        # literal on the left: normalize to column-on-left in place
        c = colname(e.right)
        if c is not None and isinstance(e.left, sa.Lit):
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            e.op = flip.get(e.op, e.op)
            e.left, e.right = e.right, e.left
            return c, e.right.value
    if isinstance(e, (sa.Between, sa.InList, sa.IsNull, sa.Like)):
        c = colname(e.expr)
        if c is not None:
            return c, None
    return None, None


class _QualifyOp(PlanOp):
    """Re-qualifies a subquery/view's output schema under its alias."""

    def __init__(self, child: PlanOp, alias: str):
        self.child = child
        self.alias = alias

    def children(self):
        return [self.child]

    def run(self):
        schema, rows = self.child.run()
        out = []
        for name, t in schema:
            bare = name.split(".", 1)[1] if "." in name else name
            out.append((f"{self.alias}.{bare}", t))
        return out, rows
