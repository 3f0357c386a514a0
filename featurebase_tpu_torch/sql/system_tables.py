"""SQL system tables (reference: sql3/planner/executionplannersystemtables.go,
opsystemtable.go — fb_table_info, fb_database_info, fb_views,
fb_exec_requests, fb_version, fb_cluster_info, fb_cluster_nodes).

Own copy of featurebase_tpu/sql/system_tables.py, single node: the cluster
tables give the one-node rows (the cluster is ROADMAP.md queue 1 item 14),
and fb_database_info's platform is the torch device type of the API's
executor ("cuda" or "cpu") where the JAX package says "tpu"."""
from __future__ import annotations

from typing import List, Tuple

SYSTEM_TABLES = {"fb_version", "fb_database_info", "fb_table_info",
                 "fb_table_columns", "fb_views", "fb_cluster_info",
                 "fb_cluster_nodes", "fb_exec_requests",
                 "fb_databases", "fb_database_nodes", "fb_tables",
                 "fb_table_ddl", "fb_functions",
                 "fb_performance_counters"}


def is_system_table(name: str) -> bool:
    return name.lower() in SYSTEM_TABLES


def run_system_table(api, name: str) -> Tuple[List[Tuple[str, str]], list]:
    name = name.lower()
    if name == "fb_version":
        from featurebase_tpu_torch import __version__
        return [("version", "string")], [[__version__]]
    if name == "fb_database_info":
        return ([("name", "string"), ("platform", "string"),
                 ("shard_width", "int")],
                [["featurebase_tpu", api.executor.device.type, 1 << 20]])
    if name == "fb_table_info":
        rows = []
        for n in sorted(api.holder.indexes):
            idx = api.holder.index(n)
            rows.append([n, idx.options.keys,
                         len(idx.public_fields()),
                         len(idx.available_shards())])
        return [("name", "string"), ("keys", "bool"),
                ("column_count", "int"), ("shard_count", "int")], rows
    if name == "fb_table_columns":
        rows = []
        for n in sorted(api.holder.indexes):
            idx = api.holder.index(n)
            for f in idx.public_fields():
                rows.append([n, f.name, f.options.type, f.options.keys])
        return [("table", "string"), ("name", "string"),
                ("type", "string"), ("keys", "bool")], rows
    if name == "fb_views":
        rows = [[vn, sql] for vn, sql in
                sorted(getattr(api.holder, "sql_views", {}).items())]
        return [("name", "string"), ("statement", "string")], rows
    if name == "fb_cluster_info":
        return ([("state", "string"), ("node_count", "int"),
                 ("replica_count", "int")], [["NORMAL", 1, 1]])
    if name == "fb_cluster_nodes":
        return [("id", "string"), ("uri", "string"), ("state", "string"),
                ("is_primary", "bool")], [["node0", "", "STARTED", True]]
    if name == "fb_exec_requests":
        reqs = getattr(api, "exec_requests", None)
        rows = reqs.rows() if reqs is not None else []
        return [("request_id", "string"), ("sql", "string"),
                ("status", "string"), ("elapsed_ms", "int")], rows
    if name == "fb_databases":
        rows = [[dn, str(opts.get("units", 1)),
                 str(opts.get("description", ""))]
                for dn, opts in sorted(
                    getattr(api.holder, "sql_databases", {}).items())]
        return [("name", "string"), ("units", "string"),
                ("description", "string")], rows
    if name == "fb_database_nodes":
        return ([("database", "string"), ("node", "string"),
                 ("state", "string")],
                [["featurebase_tpu", "node0", "STARTED"]])
    if name == "fb_tables":
        rows = []
        for n in sorted(api.holder.indexes):
            idx = api.holder.index(n)
            rows.append([n, n, "table",
                         len(idx.public_fields())])
        return [("_id", "string"), ("name", "string"),
                ("owner", "string"), ("column_count", "int")], rows
    if name == "fb_table_ddl":
        rows = []
        for n in sorted(api.holder.indexes):
            idx = api.holder.index(n)
            cols = ["_id id" if not idx.options.keys else "_id string"]
            for f in idx.public_fields():
                cols.append(f"{f.name} {_sql_type(f)}")
            rows.append([n, f"create table {n} ({', '.join(cols)});"])
        return [("table", "string"), ("ddl", "string")], rows
    if name == "fb_functions":
        from featurebase_tpu_torch.sql.functions import FUNCTIONS
        rows = [[fn, "builtin"] for fn in sorted(FUNCTIONS)]
        rows += [[fn, "user"] for fn in sorted(
            getattr(api.holder, "sql_functions", {}))]
        return [("name", "string"), ("kind", "string")], rows
    if name == "fb_performance_counters":
        from featurebase_tpu_torch.utils.metrics import REGISTRY
        d = REGISTRY.to_json()
        rows = [[k, int(v)] for k, v in sorted(d["counters"].items())]
        rows += [[k, int(v)] for k, v in sorted(d["gauges"].items())]
        return [("name", "string"), ("value", "int")], rows
    raise KeyError(name)


def _sql_type(f) -> str:
    t = f.options.type
    if t == "int":
        return "int"
    if t == "decimal":
        return f"decimal({f.options.scale})"
    if t == "timestamp":
        return "timestamp"
    if t == "bool":
        return "bool"
    base = "stringset" if f.options.keys else "idset"
    return base
