"""Command-line interface.

Own copy of featurebase_tpu/cli.py: the same parser, subcommands and flags
(reference: cmd/root.go:50, ctl/server.go:16 flags) on argparse:

  python -m featurebase_tpu_torch server [--bind HOST:PORT] [--data-dir DIR]
                                         [--cpu] [--grpc-bind HOST:PORT]
                                         [--cluster-nodes ID=URL,...]
  python -m featurebase_tpu_torch backup  --data-dir DIR --output TARFILE
                                          [--host URL]
  python -m featurebase_tpu_torch restore --source TARFILE --data-dir DIR
                                          [--host URL]
  python -m featurebase_tpu_torch import --host URL --index I FILE.csv
  python -m featurebase_tpu_torch query  --host URL --index I 'Count(All())'
  python -m featurebase_tpu_torch sql    --host URL 'SELECT ...'
  python -m featurebase_tpu_torch dax    [--computers N] [--data-dir DIR]
                                         [--snapshot-interval S]
                                         [--bind HOST:PORT] [--cpu]

`server` runs the port's API on CUDA, and raises without CUDA unless
--cpu is given (then it serves from the CPU); --mesh builds the port's
mesh over every card (eight CPU members with --cpu), and
--mesh-coordinator joins a torch.distributed group (NCCL, or Gloo with
--cpu) with one member a process.  --cluster-nodes makes the process one
node of a cluster (--name picks its id, --replicas the replica count), with
the heartbeat that probes its peers and resyncs it.  `backup` and
`restore` (and their aliases `backuptar` and `restoretar`) tar a data
directory, or with --host back up a live cluster over HTTP and restore
one into a running cluster.  The host tools run as in the JAX
package: auth-token, keygen, generate-config, wal-info, presort, chksum,
parquet-info, dataframe-csv-loader, and so do export, datagen and consume
(consume ingests into an API on CUDA, or on the CPU with --cpu).
`dax` runs a DAX deployment in one process (dax/service.py: the
controller, --computers computers over the shared writelogger and
snapshotter under --data-dir, and the queryer served on --bind), the
computers and the queryer on CUDA, or on the CPU with --cpu.

Config: flags > env (FEATUREBASE_TPU_*) > TOML file (--config), mirroring
the reference's pflag/env/TOML precedence (reference cmd/root.go:127).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tarfile


def _env_default(name: str, default):
    return os.environ.get(f"FEATUREBASE_TPU_{name.upper()}", default)


def _load_config(path):
    if not path:
        return {}
    import tomllib
    with open(path, "rb") as fh:
        return tomllib.load(fh)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="featurebase_tpu_torch")
    ap.add_argument("--config", help="TOML config file",
                    default=_env_default("config", None))
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("server", help="run the query server")
    sp.add_argument("--bind", default=_env_default("bind", "127.0.0.1:10101"))
    sp.add_argument("--data-dir", default=_env_default("data_dir", None))
    sp.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (tests/dev)")
    sp.add_argument("--name", default=_env_default("name", None),
                    help="this node's id (cluster mode)")
    sp.add_argument("--cluster-nodes",
                    default=_env_default("cluster_nodes", None),
                    help="comma list of id=http://host:port cluster members "
                         "(reference: cluster.hosts config)")
    sp.add_argument("--replicas", type=int,
                    default=int(_env_default("replicas", 1)),
                    help="replication factor (reference: cluster.replicas)")
    sp.add_argument("--grpc-bind", default=_env_default("grpc_bind", None),
                    help="HOST:PORT for the gRPC listener (reference: "
                         "grpc-listener config)")
    sp.add_argument("--auth-token", default=_env_default("auth_token", None),
                    help="shared bearer token for API + inter-node auth")
    sp.add_argument("--auth-secret",
                    default=_env_default("auth_secret", None),
                    help="HS256 shared secret for offline JWT verification "
                         "(reference: authn/authn.go OIDC middleware)")
    sp.add_argument("--auth-public-key",
                    default=_env_default("auth_public_key", None),
                    help="PEM file with the IdP's RS256 public key for "
                         "offline JWT verification")
    sp.add_argument("--auth-issuer",
                    default=_env_default("auth_issuer", None))
    sp.add_argument("--auth-audience",
                    default=_env_default("auth_audience", None))
    sp.add_argument("--auth-permissions",
                    default=_env_default("auth_permissions", None),
                    help="JSON file: {\"user-groups\": {group: {index: "
                         "read|write|admin}}, \"admin\": group} "
                         "(reference: authz/authz.go permissions YAML)")
    sp.add_argument("--lookup-dsn",
                    default=_env_default("lookup_dsn", None),
                    help="ExternalLookup() database, e.g. sqlite:PATH "
                         "(reference: lookup-db-dsn, holder.lookupDB)")
    sp.add_argument("--long-query-time", type=float,
                    default=float(_env_default("long_query_time", 0) or 0),
                    help="log queries slower than this many seconds "
                         "(reference: long-query-time)")
    sp.add_argument("--max-query-memory", type=int,
                    default=int(_env_default("max_query_memory", 0) or 0),
                    help="reject queries whose device working set exceeds "
                         "this many bytes (reference: max-query-memory)")
    sp.add_argument("--query-timeout", type=float,
                    default=float(_env_default("query_timeout", 0) or 0),
                    help="cooperative per-query deadline in seconds")
    sp.add_argument("--max-writes-per-request", type=int,
                    default=int(_env_default("max_writes_per_request",
                                             5000) or 0),
                    help="cap on mutating calls per query (reference: "
                         "server/config.go:103, default 5000)")
    sp.add_argument("--query-history-length", type=int,
                    default=int(_env_default("query_history_length",
                                             100) or 100),
                    help="per-node /query-history ring size (reference: "
                         "server/config.go:232)")
    sp.add_argument("--log-level",
                    default=_env_default("log_level", "info"),
                    choices=["debug", "info", "warn", "error"],
                    help="structured-log verbosity (reference: verbose/"
                         "log-path config)")
    sp.add_argument("--views-removal-interval", type=float,
                    default=float(_env_default("views_removal_interval",
                                               3600) or 0),
                    help="seconds between TTL time-view removal passes "
                         "(reference: server.go:920 ViewsRemoval); 0 off")
    sp.add_argument("--tls-cert", default=_env_default("tls_cert", None),
                    help="certificate PEM for HTTPS (reference: tls.* "
                         "config, server/config.go)")
    sp.add_argument("--tls-key", default=_env_default("tls_key", None))
    sp.add_argument("--mesh", action="store_true",
                    help="shard query aggregates over every local card "
                         "(a launch a member and one merge)")
    sp.add_argument("--mesh-coordinator",
                    default=_env_default("mesh_coordinator", None),
                    help="HOST:PORT of the torch.distributed rendezvous "
                         "— joins a mesh of processes, a member each")
    sp.add_argument("--mesh-processes", type=int,
                    default=int(_env_default("mesh_processes", 0) or 0))
    sp.add_argument("--mesh-process-id", type=int,
                    default=int(_env_default("mesh_process_id", 0) or 0))

    dx = sub.add_parser("dax", help="run a disaggregated DAX deployment "
                                    "(controller + computers + queryer) in "
                                    "one process")
    dx.add_argument("--bind", default=_env_default("bind", "127.0.0.1:10101"),
                    help="queryer bind address")
    dx.add_argument("--computers", type=int,
                    default=int(_env_default("computers", 2)))
    dx.add_argument("--data-dir", default=_env_default("data_dir", None))
    dx.add_argument("--snapshot-interval", type=float,
                    default=float(_env_default("snapshot_interval", 30)))
    dx.add_argument("--cpu", action="store_true")

    bp = sub.add_parser("backup", help="back up a live cluster over HTTP "
                                       "(--host) or tar a local data dir")
    bp.add_argument("--data-dir")
    bp.add_argument("--host", help="live-cluster backup: any node's URL")
    bp.add_argument("--output", "-o", required=True)

    rp = sub.add_parser("restore", help="restore a backup tar into a live "
                                        "cluster (--host) or a data dir")
    rp.add_argument("--source", required=True)
    rp.add_argument("--data-dir")
    rp.add_argument("--host", help="live-cluster restore: any node's URL")

    # tar-named aliases (reference: featurebase backuptar/restoretar —
    # our backup/restore already produce/consume tars)
    bt = sub.add_parser("backuptar", help="alias of backup")
    bt.add_argument("--data-dir")
    bt.add_argument("--host")
    bt.add_argument("--output", "-o", required=True)
    rt = sub.add_parser("restoretar", help="alias of restore")
    rt.add_argument("--source", required=True)
    rt.add_argument("--data-dir")
    rt.add_argument("--host")

    ip = sub.add_parser("import", help="import a CSV file")
    ip.add_argument("--host", default=_env_default("host",
                                                   "http://127.0.0.1:10101"))
    ip.add_argument("--index", required=True)
    ip.add_argument("--id-column", default="id")
    ip.add_argument("file")

    ep = sub.add_parser("export", help="export a fragment as roaring bytes")
    ep.add_argument("--host", default=_env_default("host",
                                                   "http://127.0.0.1:10101"))
    ep.add_argument("--index", required=True)
    ep.add_argument("--field", required=True)
    ep.add_argument("--shard", type=int, default=0)
    ep.add_argument("--view", default="standard")
    ep.add_argument("-o", "--output", default="-")

    qp = sub.add_parser("query", help="run a PQL query")
    qp.add_argument("--host", default=_env_default("host",
                                                   "http://127.0.0.1:10101"))
    qp.add_argument("--index", required=True)
    qp.add_argument("pql")

    qs = sub.add_parser("sql", help="run a SQL query")
    qs.add_argument("--host", default=_env_default("host",
                                                   "http://127.0.0.1:10101"))
    qs.add_argument("--token", default=None,
                    help="bearer token for an auth-enabled server")
    qs.add_argument("sql", nargs="?", default=None,
                    help="statement; omit for the interactive fbsql shell")

    at = sub.add_parser(
        "auth-token", help="mint an HS256 bearer token for the configured "
        "auth secret (reference: featurebase auth-token)")
    at.add_argument("--secret", required=True)
    at.add_argument("--sub", default="admin")
    at.add_argument("--groups", default="admins",
                    help="comma-separated group list")
    at.add_argument("--ttl", type=float, default=3600.0)
    at.add_argument("--issuer", default=None)
    at.add_argument("--audience", default=None)

    kg = sub.add_parser(
        "keygen", help="generate auth keys: an HS256 shared secret, or an "
        "RS256 keypair with --rsa (reference: featurebase keygen)")
    kg.add_argument("--rsa", action="store_true")
    kg.add_argument("--out-prefix", default="featurebase-auth")

    sub.add_parser(
        "generate-config", help="print a commented TOML config with the "
        "defaults (reference: featurebase generate-config)")

    ps = sub.add_parser(
        "presort", help="split a CSV/NDJSON ingest file into per-key-"
        "partition files so each partition's owner can import its slice "
        "(reference: featurebase presort, ctl/presort.go)")
    ps.add_argument("--file", required=True)
    ps.add_argument("--type", default="ndjson", choices=["ndjson", "csv"])
    ps.add_argument("--table", required=True,
                    help="index name (keys hash as FNV(index, key))")
    ps.add_argument("--primary-key-fields", required=True,
                    help="comma list of fields forming the record key")
    ps.add_argument("--primary-key-separator", default="|")
    ps.add_argument("--partition-n", type=int, default=256)
    ps.add_argument("--output-dir", default="presorted_files")

    wi = sub.add_parser(
        "wal-info", help="inspect a data dir's WAL: entries by op, "
        "bytes, bad lines (the rbf check/dump role — reference: "
        "ctl/rbf_*.go — for this engine's JSONL WAL)")
    wi.add_argument("--data-dir", required=True)
    wi.add_argument("--verbose", "-v", action="store_true",
                    help="also print each entry's op + key fields")

    pq = sub.add_parser(
        "parquet-info", help="print a parquet file's schema + row count "
        "(reference: featurebase parquet-info, cmd/)")
    pq.add_argument("file")

    dl = sub.add_parser(
        "dataframe-csv-loader", help="load a CSV into an index's columnar "
        "dataframe side-store (reference: featurebase "
        "dataframe-csv-loader, cmd/)")
    dl.add_argument("--host", default=_env_default("host",
                                                   "http://127.0.0.1:10101"))
    dl.add_argument("--index", required=True)
    dl.add_argument("--id-column", default="id")
    dl.add_argument("file")

    ck = sub.add_parser(
        "chksum", help="print per-fragment checksums of a live node "
        "(reference: featurebase chksum, ctl/chksum.go — compare nodes "
        "for divergence)")
    ck.add_argument("--host", default=_env_default("host",
                                                   "http://127.0.0.1:10101"))
    ck.add_argument("--index", default=None)

    dg = sub.add_parser(
        "datagen", help="generate synthetic data into an index or a "
        "kafka topic (reference: idk/datagen)")
    dg.add_argument("--source", default="",
                    help="generator: customer|equipment|kitchen-sink|"
                    "custom (empty lists available sources)")
    dg.add_argument("--index", default="", help="target index name")
    dg.add_argument("--host", default="http://127.0.0.1:10101",
                    help="server URL (index target)")
    dg.add_argument("--start-from", type=int, default=0)
    dg.add_argument("--end-at", type=int, default=999)
    dg.add_argument("--seed", type=int, default=0)
    dg.add_argument("--batch-size", type=int, default=10000)
    dg.add_argument("--target", default="index",
                    choices=["index", "kafka"])
    dg.add_argument("--kafka-host", default="127.0.0.1")
    dg.add_argument("--kafka-port", type=int, default=9092)
    dg.add_argument("--topic", default="datagen")
    dg.add_argument("--custom-config", default="",
                    help="JSON schema file for --source custom")
    dg.add_argument("--file", default="",
                    help="CSV/JSON-lines file to ship to kafka "
                    "(--source file; reference: idk kafkaput)")
    dg.add_argument("--key-column", default="",
                    help="column used as the kafka message key")

    kc = sub.add_parser(
        "consume", help="Kafka consumer ingest into a durable data dir "
        "(reference: molecula-consumer-kafka, idk/cmd)")
    kc.add_argument("--bootstrap", required=True, help="HOST:PORT broker")
    kc.add_argument("--topic", required=True)
    kc.add_argument("--group", default="featurebase-tpu")
    kc.add_argument("--index", required=True)
    kc.add_argument("--data-dir", required=True)
    kc.add_argument("--id-field", default="id")
    kc.add_argument("--auto-id", action="store_true",
                    help="allocate record ids via the ID allocator")
    kc.add_argument("--batch-size", type=int, default=4096)
    kc.add_argument("--max-batches", type=int, default=None)
    kc.add_argument("--sasl-user", default=None,
                    help="SASL/PLAIN username (broker auth)")
    kc.add_argument("--sasl-password", default=None)
    kc.add_argument("--cpu", action="store_true",
                    help="ingest into an API on the CPU (default: CUDA)")
    kc.add_argument("--avro-schema", default=None,
                    help="JSON file {schema_id: avro schema} for "
                         "Confluent-framed values")

    args = ap.parse_args(argv)
    cfg = _load_config(args.config)

    if args.cmd == "server":
        return cmd_server(args, cfg)
    if args.cmd == "dax":
        return cmd_dax(args, cfg)
    if args.cmd in ("backup", "backuptar"):
        return cmd_backup(args)
    if args.cmd in ("restore", "restoretar"):
        return cmd_restore(args)
    if args.cmd == "auth-token":
        return cmd_auth_token(args)
    if args.cmd == "keygen":
        return cmd_keygen(args)
    if args.cmd == "generate-config":
        return cmd_generate_config(args)
    if args.cmd == "presort":
        return cmd_presort(args)
    if args.cmd == "wal-info":
        return cmd_wal_info(args)
    if args.cmd == "import":
        return cmd_import(args)
    if args.cmd == "export":
        return cmd_export(args)
    if args.cmd == "query":
        return cmd_query(args)
    if args.cmd == "sql":
        return cmd_sql(args)
    if args.cmd == "consume":
        return cmd_consume(args)
    if args.cmd == "chksum":
        return cmd_chksum(args)
    if args.cmd == "parquet-info":
        return cmd_parquet_info(args)
    if args.cmd == "dataframe-csv-loader":
        return cmd_dataframe_csv_loader(args)
    if args.cmd == "datagen":
        return cmd_datagen(args)
    return 2


def cmd_datagen(args):
    import json as _json

    from featurebase_tpu_torch.ingest import datagen as dg
    if not args.source:
        print("available sources:",
              ", ".join(sorted(dg.builtin_sources())), "or custom")
        return 0
    custom = None
    if args.custom_config:
        with open(args.custom_config) as fh:
            custom = _json.load(fh)
    if args.target == "kafka":
        from featurebase_tpu_torch.ingest.kafka_source import KafkaClient
        c = KafkaClient(args.kafka_host, args.kafka_port)
        try:
            c.negotiate()
            if args.source == "file":
                n = dg.load_kafka_file(c, args.topic, args.file,
                                       key_column=args.key_column or None,
                                       batch_size=args.batch_size)
            else:
                n = dg.load_kafka(c, args.topic, args.source,
                                  args.start_from, args.end_at, args.seed,
                                  batch_size=args.batch_size,
                                  custom=custom)
        finally:
            c.close()
        print(f"produced {n} records to {args.topic}")
        return 0
    if not args.index:
        print("datagen: --index required for the index target")
        return 2
    from featurebase_tpu_torch.client import Client
    cl = Client(args.host)  # mirrors the API import/schema surface
    n = dg.load_index(cl, args.index, args.source, args.start_from,
                      args.end_at, args.seed, args.batch_size,
                      custom=custom,
                      progress=lambda t: print(f"\r{t} records", end=""))
    print(f"\ngenerated {n} records into {args.index}")
    return 0


def cmd_parquet_info(args):
    """Reference: featurebase parquet-info — schema + row count."""
    import pyarrow.parquet as pq
    f = pq.ParquetFile(args.file)
    print(f"rows: {f.metadata.num_rows}")
    print(f"row groups: {f.metadata.num_row_groups}")
    for field in f.schema_arrow:
        print(f"  {field.name}: {field.type}")
    return 0


def cmd_dataframe_csv_loader(args):
    """Reference: featurebase dataframe-csv-loader — CSV rows into the
    per-shard columnar side-store over /index/{i}/dataframe/{shard}."""
    import csv
    import json as _json
    import urllib.request

    from featurebase_tpu_torch.core.consts import SHARD_WIDTH
    by_shard: dict = {}
    with open(args.file, newline="") as fh:
        for row in csv.DictReader(fh):
            rid = int(row[args.id_column])
            cols = by_shard.setdefault(rid // SHARD_WIDTH, {})
            cols.setdefault("_id", []).append(rid)
            for k, v in row.items():
                if k == args.id_column:
                    continue
                try:
                    v = int(v)
                except ValueError:
                    try:
                        v = float(v)
                    except ValueError:
                        pass
                cols.setdefault(k, []).append(v)
    total = 0
    for shard, cols in sorted(by_shard.items()):
        req = urllib.request.Request(
            f"{args.host}/index/{args.index}/dataframe/{shard}",
            data=_json.dumps({"columns": cols}).encode(), method="POST")
        req.add_header("Content-Type", "application/json")
        with urllib.request.urlopen(req, timeout=120) as resp:
            resp.read()
        total += len(cols["_id"])
    print(f"loaded {total} rows into {args.index} dataframe "
          f"({len(by_shard)} shards)")
    return 0


def cmd_chksum(args):
    """Per-index/shard/fragment checksums over HTTP (reference:
    ctl/chksum.go — xxhash over cluster data; here the engine's own
    per-fragment block checksums, comparable across nodes)."""
    import json as _json
    import urllib.request

    def get(path):
        with urllib.request.urlopen(args.host + path, timeout=60) as r:
            return _json.loads(r.read())

    schema = get("/schema").get("indexes", [])
    for idx in schema:
        name = idx["name"]
        if args.index and name != args.index:
            continue
        shards = get(f"/shards?index={name}").get("shards", [])
        for s in shards:
            info = get(f"/internal/index/{name}/shard/{s}/fragments")
            for fr in info.get("fragments", []):
                print(f"{name}\tshard={s}\t{fr['field']}/{fr['view']}\t"
                      f"rows={fr['rows']}\tchksum={fr['checksum']:08x}")
    return 0


def cmd_consume(args):
    """Kafka-protocol consumer -> durable local API on the card (on the
    CPU with --cpu) (reference: idk molecula-consumer-kafka, idk/cmd)."""
    import json as _json

    from featurebase_tpu_torch.ingest.idk import Ingester
    from featurebase_tpu_torch.ingest.kafka_source import (AvroDeserializer,
                                                           KafkaSource)
    from featurebase_tpu_torch.server.api import API
    deser = None
    if args.avro_schema:
        with open(args.avro_schema) as fh:
            reg = {int(k): v for k, v in _json.load(fh).items()}
        deser = AvroDeserializer(reg)
    api = API(data_dir=args.data_dir, device="cpu" if args.cpu else None)
    src = KafkaSource(args.bootstrap, args.topic, group=args.group,
                      deserializer=deser,
                      sasl_user=getattr(args, "sasl_user", None),
                      sasl_password=getattr(args, "sasl_password", None))
    ing = Ingester(api, args.index, src,
                   batch_size=args.batch_size,
                   id_field=None if args.auto_id else args.id_field)
    stats = ing.run(max_batches=args.max_batches)
    print(_json.dumps(stats))
    return 0


def cmd_server(args, cfg):
    cpu = bool(getattr(args, "cpu", False))
    bind = cfg.get("bind", args.bind)
    host, _, port = bind.partition(":")
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.server.http_server import Server
    auth_token = cfg.get("auth-token", args.auth_token)
    cluster = None
    nodes_spec = cfg.get("cluster-nodes", args.cluster_nodes)
    if nodes_spec:
        from featurebase_tpu_torch.cluster.client import InternalClient
        from featurebase_tpu_torch.cluster.cluster import Cluster
        nodes = []
        for item in nodes_spec.split(","):
            nid, _, uri = item.strip().partition("=")
            nodes.append({"id": nid, "uri": uri})
        cluster = Cluster(cfg.get("name", args.name) or nodes[0]["id"],
                          nodes,
                          replicas=int(cfg.get("replicas", args.replicas)),
                          client=InternalClient(auth_token=auth_token))
    lqt = float(cfg.get("long-query-time", args.long_query_time) or 0)
    mqm = int(cfg.get("max-query-memory", args.max_query_memory) or 0)
    qto = float(cfg.get("query-timeout", args.query_timeout) or 0)
    # compute-plane mesh: every local card (--mesh), or one member a
    # process of a torch.distributed group (--mesh-coordinator)
    mesh = None
    coord = cfg.get("mesh-coordinator", args.mesh_coordinator)
    if coord:
        from featurebase_tpu_torch.parallel import multihost
        multihost.initialize(
            coord, int(cfg.get("mesh-processes", args.mesh_processes)),
            int(cfg.get("mesh-process-id", args.mesh_process_id)),
            backend="gloo" if cpu else "nccl")
        mesh = multihost.global_mesh(1, "cpu" if cpu else "cuda")
    elif cfg.get("mesh", None) or args.mesh:
        from featurebase_tpu_torch.parallel.mesh import make_mesh
        mesh = make_mesh(devices=["cpu"] * 8) if cpu else make_mesh()
    api = API(data_dir=cfg.get("data-dir", args.data_dir), cluster=cluster,
              mesh=mesh, long_query_time=lqt or None,
              max_query_memory=mqm or None, query_timeout=qto or None,
              query_history_length=int(cfg.get(
                  "query-history-length", args.query_history_length)),
              max_writes_per_request=int(cfg.get(
                  "max-writes-per-request",
                  args.max_writes_per_request)) or None,
              device="cpu" if cpu else None)
    from featurebase_tpu_torch.utils.logger import LEVELS
    api.logger.level = LEVELS.get(
        str(cfg.get("log-level", args.log_level)), 20)
    if auth_token:
        api.auth_token = auth_token
    secret = cfg.get("auth-secret", args.auth_secret)
    pubkey_path = cfg.get("auth-public-key", args.auth_public_key)
    perms_path = cfg.get("auth-permissions", args.auth_permissions)
    if (secret or pubkey_path) and perms_path:
        from featurebase_tpu_torch.server.auth import (Auth, GroupAuthorizer,
                                                       TokenVerifier)
        pem = open(pubkey_path, "rb").read() if pubkey_path else None
        api.auth = Auth(
            TokenVerifier(secret=secret, public_key_pem=pem,
                          issuer=cfg.get("auth-issuer", args.auth_issuer),
                          audience=cfg.get("auth-audience",
                                           args.auth_audience)),
            GroupAuthorizer.from_file(perms_path))
    lookup_dsn = cfg.get("lookup-dsn", args.lookup_dsn)
    if lookup_dsn:
        from featurebase_tpu_torch.storage.lookup import open_lookup
        api.holder.lookup_db = open_lookup(lookup_dsn)
    if cluster is not None:
        # liveness and convergence loop (reference: etcd heartbeats and
        # holderSyncer); it also makes the first schema and translate pull
        cluster.start_heartbeat(api)
    vri = float(cfg.get("views-removal-interval",
                        args.views_removal_interval) or 0)
    if vri > 0:
        api.start_views_removal(vri)
    srv = Server(api=api, host=host or "127.0.0.1", port=int(port or 10101),
                 tls_cert=cfg.get("tls-cert", args.tls_cert),
                 tls_key=cfg.get("tls-key", args.tls_key))
    grpc_bind = cfg.get("grpc-bind", args.grpc_bind)
    grpc_srv = None
    if grpc_bind:
        from featurebase_tpu_torch.server.grpc_server import GRPCServer
        gh, _, gp = grpc_bind.partition(":")
        grpc_srv = GRPCServer(api=api, host=gh or "127.0.0.1",
                              port=int(gp or 20101),
                              tls_cert=cfg.get("tls-cert", args.tls_cert),
                              tls_key=cfg.get("tls-key", args.tls_key)
                              ).start()
        print(f"featurebase_tpu_torch gRPC on {grpc_srv.address}",
              flush=True)
    print(f"featurebase_tpu_torch serving on {srv.url}", flush=True)
    try:
        srv.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if grpc_srv is not None:
            grpc_srv.stop()
        srv.stop()
    return 0


def cmd_dax(args, cfg):
    """Reference: `featurebase dax` (cmd/dax.go) — all services in one
    process via the service manager; the computers and the queryer on the
    card, or on the CPU with --cpu."""
    from featurebase_tpu_torch.dax.service import DaxService
    from featurebase_tpu_torch.server.http_server import Server
    svc = DaxService(n_computers=int(cfg.get("computers", args.computers)),
                     data_dir=cfg.get("data-dir", args.data_dir),
                     snapshot_interval=float(
                         cfg.get("snapshot-interval",
                                 args.snapshot_interval)),
                     device="cpu" if getattr(args, "cpu", False) else None)
    bind = cfg.get("bind", args.bind)
    host, _, port = bind.partition(":")
    try:
        front = Server(api=svc.queryer, host=host or "127.0.0.1",
                       port=int(port or 10101))
    except BaseException:
        svc.close()
        raise
    print(f"featurebase_tpu_torch dax: controller={svc.controller_uri} "
          f"computers={len(svc.computers)} queryer={front.url}", flush=True)
    try:
        front.httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        front.stop()
        svc.close()
    return 0


def cmd_backup(args):
    """Back up a live cluster over HTTP (reference ctl/backup.go:87: schema
    + per-partition translate data + per-shard snapshots), or tar a local
    data dir when --host is not given."""
    if getattr(args, "host", None):
        return _live_backup(args.host, args.output)
    data_dir = args.data_dir
    if not data_dir or not os.path.isdir(data_dir):
        print(f"no such data dir: {data_dir}", file=sys.stderr)
        return 1
    with tarfile.open(args.output, "w:gz") as tf:
        tf.add(data_dir, arcname=".")
    print(f"backed up {data_dir} -> {args.output}")
    return 0


def _live_backup(host: str, output: str) -> int:
    """GET /schema + translate snapshot + every shard's snapshot bundle
    from the shard's first live owner (reference: ctl/backup.go:342 fetches
    /internal/index/{i}/shard/{s}/snapshot from a node owning the shard)."""
    import io
    schema = _http(host, "GET", "/schema")
    translate = _http(host, "GET", "/internal/translate/snapshot")
    with tarfile.open(output, "w:gz") as tf:
        def put(name, data: bytes):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        put("schema.json", json.dumps(schema).encode())
        put("translate.json", json.dumps(translate).encode())
        idalloc = _http(host, "GET", "/internal/idalloc/data")
        put("idalloc.json", json.dumps(idalloc).encode())
        n_shards = 0
        for idx in schema.get("indexes", []):
            name = idx["name"]
            shards = _http(host, "GET",
                           f"/shards?index={name}&cluster=1")["shards"]
            for s in shards:
                data = _http(host, "GET",
                             f"/internal/index/{name}/shard/{s}/snapshot",
                             raw=True)
                put(f"shards/{name}/{s}.npz", data)
                n_shards += 1
    print(f"backed up {host} ({n_shards} shards) -> {output}")
    return 0


def cmd_restore(args):
    if getattr(args, "host", None):
        return _live_restore(args.host, args.source)
    if not args.data_dir:
        print("restore requires --data-dir or --host", file=sys.stderr)
        return 1
    os.makedirs(args.data_dir, exist_ok=True)
    with tarfile.open(args.source, "r:*") as tf:
        tf.extractall(args.data_dir, filter="data")
    print(f"restored {args.source} -> {args.data_dir}")
    return 0


def _live_restore(host: str, source: str) -> int:
    """Recreate schema, translate state, and every shard on a live cluster
    (reference: ctl/restore.go POST /internal/restore/{index}/{shard}; the
    receiving node fans the bundle out to all owners of the shard).  The
    translate stores go to every node (each node keeps them whole; the JAX
    package's restore gives them to `host` alone)."""
    with tarfile.open(source, "r:*") as tf:
        members = {m.name: m for m in tf.getmembers()}
        schema = json.loads(tf.extractfile(members["schema.json"]).read())
        for idx in schema.get("indexes", []):
            _http(host, "POST", f"/index/{idx['name']}",
                  {"options": idx.get("options", {})})
            for f in idx.get("fields", []):
                if f["name"].startswith("_"):
                    continue
                _http(host, "POST",
                      f"/index/{idx['name']}/field/{f['name']}",
                      {"options": f.get("options", {})})
        translate = json.loads(
            tf.extractfile(members["translate.json"]).read())
        nodes = [n["uri"] for n in _http(host, "GET", "/internal/nodes")
                 if n.get("uri")] or [host]
        for uri in nodes:
            _http(uri, "POST", "/internal/translate/restore",
                  {"snap": translate})
        if "idalloc.json" in members:  # absent in older backups
            _http(host, "POST", "/internal/idalloc/restore",
                  json.loads(tf.extractfile(
                      members["idalloc.json"]).read()))
        n_shards = 0
        for name, m in members.items():
            if not name.startswith("shards/"):
                continue
            _, index, fname = name.split("/", 2)
            shard = int(fname.removesuffix(".npz"))
            _http(host, "POST", f"/internal/restore/{index}/{shard}",
                  tf.extractfile(m).read())
            n_shards += 1
    print(f"restored {source} ({n_shards} shards) -> {host}")
    return 0


def _http(host, method, path, body=None, raw=False):
    import urllib.request
    req = urllib.request.Request(
        host + path, method=method,
        data=(body if isinstance(body, bytes) else
              json.dumps(body).encode()) if body is not None else None)
    with urllib.request.urlopen(req) as resp:
        data = resp.read()
    return data if raw else json.loads(data)


def cmd_import(args):
    import csv as _csv
    with open(args.file, newline="") as fh:
        reader = _csv.DictReader(fh)
        headers = [h for h in (reader.fieldnames or [])
                   if h != args.id_column]
        rows = list(reader)
    # create fields (int if all-int else keyed mutex), then POST imports
    def is_int(v):
        try:
            int(v)
            return True
        except (TypeError, ValueError):
            return False
    _http(args.host, "POST", f"/index/{args.index}", {"options": {}})
    for h in headers:
        vals = [r[h] for r in rows if r.get(h)]
        if vals and all(is_int(v) for v in vals):
            iv = [int(v) for v in vals]
            opts = {"type": "int", "min": min(iv), "max": max(iv)}
        else:
            opts = {"type": "mutex", "keys": True}
        try:
            _http(args.host, "POST",
                  f"/index/{args.index}/field/{h}", {"options": opts})
        except Exception:
            pass
    for h in headers:
        cols, vals = [], []
        for r in rows:
            v = r.get(h)
            if not v:
                continue
            cols.append(int(r[args.id_column]))
            vals.append(v)
        if not cols:
            continue
        if all(is_int(v) for v in vals):
            _http(args.host, "POST",
                  f"/index/{args.index}/field/{h}/import",
                  {"columnIDs": cols, "values": [int(v) for v in vals]})
        else:
            _http(args.host, "POST",
                  f"/index/{args.index}/field/{h}/import",
                  {"columnIDs": cols, "rowKeys": vals})
    print(f"imported {len(rows)} records into {args.index}")
    return 0


def cmd_export(args):
    data = _http(args.host, "GET",
                 f"/export?index={args.index}&field={args.field}"
                 f"&shard={args.shard}&view={args.view}", raw=True)
    if args.output == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.output, "wb") as fh:
            fh.write(data)
        print(f"wrote {len(data)} bytes to {args.output}")
    return 0


def cmd_auth_token(args):
    """Mint an HS256 bearer token (reference: featurebase auth-token)."""
    from featurebase_tpu_torch.server.auth import mint_hs256
    print(mint_hs256(args.secret, args.sub,
                     [g for g in args.groups.split(",") if g],
                     ttl=args.ttl, issuer=args.issuer,
                     audience=args.audience))
    return 0


def cmd_keygen(args):
    """Generate auth keys (reference: featurebase keygen)."""
    if not args.rsa:
        import secrets
        print(secrets.token_urlsafe(32))
        return 0
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    priv = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())
    pub = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo)
    with open(args.out_prefix + ".key", "wb") as fh:
        fh.write(priv)
    with open(args.out_prefix + ".pub", "wb") as fh:
        fh.write(pub)
    print(f"wrote {args.out_prefix}.key and {args.out_prefix}.pub")
    return 0


def cmd_generate_config(args):
    """Print a commented TOML config with the defaults (reference:
    featurebase generate-config)."""
    print("""\
# featurebase-tpu server configuration (flags > FEATUREBASE_TPU_* env >
# this file; pass with --config)

bind = "127.0.0.1:10101"
data-dir = ""            # enable WAL + snapshots when set
# long-query-time = 1.0  # seconds; slower queries are logged
# max-query-memory = 0   # bytes; 0 = unlimited
# query-timeout = 0.0    # seconds; 0 = none

[cluster]
# name = "cluster0"
# replicas = 1
# seeds = ["http://127.0.0.1:10101"]

[auth]
# enable = true
# secret = "..."          # HS256 shared secret (or rsa public key file)
# permissions = "perms.yaml"

[tls]
# certificate = "srv.crt"
# key = "srv.key"
""")
    return 0


def cmd_wal_info(args):
    """WAL inspector (the rbf check/dump role for the JSONL WAL):
    per-op entry counts, total bytes, and undecodable lines."""
    path = os.path.join(args.data_dir, "wal.jsonl")
    if not os.path.exists(path):
        print(f"no WAL at {path}", file=sys.stderr)
        return 1
    counts = {}
    total = bad = 0
    with open(path, "rb") as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            total += 1
            try:
                e = json.loads(line)
            except ValueError:
                bad += 1
                print(f"line {i}: undecodable ({len(line)} bytes)")
                continue
            op = e.get("op", "?")
            counts[op] = counts.get(op, 0) + 1
            if args.verbose:
                keys = {k: e[k] for k in ("i", "f", "name", "shard",
                                          "idx", "term")
                        if k in e}
                print(f"line {i}: {op} {keys}")
    size = os.path.getsize(path)
    print(f"{path}: {total} entries, {size} bytes"
          + (f", {bad} BAD" if bad else ""))
    for op in sorted(counts, key=counts.get, reverse=True):
        print(f"  {op:14s} {counts[op]}")
    return 1 if bad else 0


def cmd_presort(args):
    """Split an ingest file into per-key-partition files (reference:
    ctl/presort.go — FNV(index, key) % partition_n routing, so each
    partition's primary can bulk-import its own slice)."""
    import csv as _csv

    from featurebase_tpu_torch.storage.translate import key_to_key_partition
    os.makedirs(args.output_dir, exist_ok=True)
    pk = [f.strip() for f in args.primary_key_fields.split(",") if f]
    sep = args.primary_key_separator
    outs = {}
    n = 0

    def sink(part):
        f = outs.get(part)
        if f is None:
            ext = "csv" if args.type == "csv" else "ndjson"
            f = outs[part] = open(
                os.path.join(args.output_dir,
                             f"partition_{part}.{ext}"), "w", newline="")
        return f

    with open(args.file, newline="") as fh:
        if args.type == "csv":
            reader = _csv.reader(fh)
            header = next(reader)
            hidx = {h: i for i, h in enumerate(header)}
            missing = [f for f in pk if f not in hidx]
            if missing:
                print(f"key fields not in header: {missing}",
                      file=sys.stderr)
                return 1
            writers = {}
            for row in reader:
                key = sep.join(row[hidx[f]] for f in pk)
                part = key_to_key_partition(args.table, key,
                                            args.partition_n)
                w = writers.get(part)
                if w is None:
                    f = sink(part)
                    w = writers[part] = _csv.writer(f)
                    w.writerow(header)
                w.writerow(row)
                n += 1
        else:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                key = sep.join(str(rec.get(f, "")) for f in pk)
                part = key_to_key_partition(args.table, key,
                                            args.partition_n)
                sink(part).write(line + "\n")
                n += 1
    for f in outs.values():
        f.close()
    print(f"presorted {n} records into {len(outs)} partition files "
          f"under {args.output_dir}")
    return 0


def cmd_query(args):
    out = _http(args.host, "POST", f"/index/{args.index}/query",
                {"query": args.pql})
    print(json.dumps(out, indent=2))
    return 0


def cmd_sql(args):
    if args.sql:
        out = _http(args.host, "POST", "/sql", {"sql": args.sql})
        print(json.dumps(out, indent=2))
        return 0
    # no statement: interactive fbsql shell (reference: cli/cli.go)
    from featurebase_tpu_torch.fbsql import Shell
    Shell(args.host, token=getattr(args, "token", None)).interact()
    return 0


if __name__ == "__main__":
    sys.exit(main())
