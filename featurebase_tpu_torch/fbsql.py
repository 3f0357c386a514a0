"""fbsql — the interactive SQL shell.

Mirrors the reference's fbsql CLI (reference: cli/cli.go — psql-style REPL
over the /sql endpoint with meta commands and aligned table output).
Statements end with ';'; meta commands:

  \\q                 quit
  \\dt                list tables
  \\d <table>         describe a table's columns
  \\timing [on|off]   toggle per-query timing
  \\i <file>          execute statements from a file
  \\ingest <cfg.json> run a Kafka-source ingest into the connected
                      server (reference: fbsql kafka config, cli/cli.go;
                      maps onto the IDK kit, ingest/kafka_source.py)

\\ingest config keys: bootstrap "host:port", topic, index; optional
group, id_field (default "id"), batch_size, max_batches, and fields
{name: type-or-options} created on the server before consuming.

Non-interactive use: pipe statements on stdin (`echo "SELECT 1;" | fbsql`).

Own copy of featurebase_tpu/fbsql.py; it speaks HTTP only, and \\ingest
consumes through the port's Kafka source (ingest/kafka_source.py) into the
server's HTTP import endpoints.
"""
from __future__ import annotations

import json
import sys
import time
import urllib.error
import urllib.request
from typing import List, Optional


def _post_sql(host: str, sql: str, timeout: float = 60.0,
              token: Optional[str] = None) -> dict:
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        host + "/sql", data=json.dumps({"sql": sql}).encode(),
        method="POST", headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        try:
            return {"error": json.loads(e.read()).get("error", str(e))}
        except Exception:  # noqa: BLE001
            return {"error": str(e)}


def render_table(out: dict) -> str:
    """Aligned psql-style table from {"schema": [...], "data": [[...]]}."""
    if "error" in out:
        return f"ERROR: {out['error']}"
    schema = out.get("schema") or []
    if isinstance(schema, dict):  # WireQueryResponse shape: {"fields": []}
        schema = schema.get("fields", [])
    headers = [c.get("name", f"col{i}") if isinstance(c, dict) else str(c)
               for i, c in enumerate(schema)]
    rows = out.get("data", [])
    if not headers and rows:
        headers = [f"col{i}" for i in range(len(rows[0]))]
    if not headers:
        return f"({len(rows)} rows)" if rows else "OK"

    def fmt(v) -> str:
        if v is None:
            return "NULL"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, list):
            return "[" + ",".join(fmt(x) for x in v) + "]"
        return str(v)

    cells = [[fmt(v) for v in r] for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in cells)) if cells else len(h)
              for i, h in enumerate(headers)]
    lines = [" | ".join(h.ljust(w) for h, w in zip(headers, widths)),
             "-+-".join("-" * w for w in widths)]
    for r in cells:
        lines.append(" | ".join(c.ljust(w) for c, w in zip(r, widths)))
    lines.append(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
    return "\n".join(lines)


def _post_json(host: str, path: str, body: dict,
               ok_statuses=(409,), token: Optional[str] = None
               ) -> Optional[dict]:
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(
        host + path, data=json.dumps(body).encode(), method="POST",
        headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        if e.code in ok_statuses:  # already-exists is fine for schema
            return None
        raise


def kafka_ingest(host: str, cfg: dict,
                 token: Optional[str] = None) -> dict:
    """Consume a Kafka topic into the connected server over its HTTP
    import endpoints (the remote counterpart of `featurebase-tpu
    consume`; reference: fbsql's kafka ingest configuration,
    cli/cli.go).  Returns {"records": n, "batches": b}."""
    from featurebase_tpu_torch.ingest.idk import Recordizer
    from featurebase_tpu_torch.ingest.kafka_source import KafkaSource

    def post(path, body, ok=(409,)):
        return _post_json(host, path, body, ok_statuses=ok, token=token)

    index = cfg["index"]
    post(f"/index/{index}", {"options": cfg.get(
        "index_options", {"trackExistence": True})})
    fields = cfg.get("fields", {})
    for name, opts in fields.items():
        if isinstance(opts, str):
            opts = {"type": opts}
        post(f"/index/{index}/field/{name}", {"options": opts})
    bootstrap = cfg["bootstrap"]
    src = KafkaSource(bootstrap, cfg["topic"],
                      group=cfg.get("group", "fbsql"),
                      sasl_user=cfg.get("sasl_user"),
                      sasl_password=cfg.get("sasl_password"))
    rec = Recordizer(id_field=cfg.get("id_field", "id"))
    batch_size = int(cfg.get("batch_size", 4096))
    max_batches = cfg.get("max_batches")
    n_records = n_batches = 0
    while max_batches is None or n_batches < int(max_batches):
        records = src.poll(batch_size)
        if not records:
            break
        per_field: dict = {}
        for raw in records:
            rid, vals = rec(raw)
            if rid is None:
                continue
            for fname, v in vals.items():
                if v is None or (fields and fname not in fields):
                    continue
                per_field.setdefault(fname, []).append((rid, v))
        for fname, pairs in per_field.items():
            cols = [p[0] for p in pairs]
            vals = [p[1] for p in pairs]
            if all(isinstance(v, (int, float)) and
                   not isinstance(v, bool) for v in vals) and \
                    (fields.get(fname) in ("int", "decimal", "timestamp")
                     or (isinstance(fields.get(fname), dict) and
                         fields[fname].get("type") in
                         ("int", "decimal", "timestamp"))):
                body = {"columnIDs": cols, "values": vals}
            else:
                key = "rowKeys" if any(isinstance(v, str) for v in vals) \
                    else "rowIDs"
                body = {key: vals, "columnIDs": cols}
            post(f"/index/{index}/field/{fname}/import", body, ok=())
        src.commit()
        n_records += len(records)
        n_batches += 1
    return {"records": n_records, "batches": n_batches}


class Shell:
    def __init__(self, host: str, out=None, token: Optional[str] = None):
        self.host = host
        self.out = out or sys.stdout
        self.timing = False
        self.token = token  # bearer auth (reference: fbsql cloud auth)
        self._buf: List[str] = []

    def _print(self, s: str):
        print(s, file=self.out)

    def run_sql(self, sql: str):
        t0 = time.perf_counter()
        res = _post_sql(self.host, sql, token=self.token)
        dt = (time.perf_counter() - t0) * 1e3
        self._print(render_table(res))
        if self.timing:
            self._print(f"Time: {dt:.1f} ms")

    def meta(self, line: str) -> bool:
        """Handle a backslash command; returns False to quit."""
        parts = line.split()
        cmd = parts[0]
        if cmd in ("\\q", "\\quit"):
            return False
        if cmd == "\\auth":
            self.token = parts[1] if len(parts) > 1 else None
            self._print("Auth token " +
                        ("set." if self.token else "cleared."))
            return True
        if cmd == "\\dt":
            self.run_sql("SHOW TABLES")
        elif cmd == "\\d" and len(parts) > 1:
            self.run_sql(f"SHOW COLUMNS FROM {parts[1]}")
        elif cmd == "\\d":
            self.run_sql("SHOW TABLES")
        elif cmd == "\\timing":
            if len(parts) > 1:
                self.timing = parts[1].lower() == "on"
            else:
                self.timing = not self.timing
            self._print(f"Timing is {'on' if self.timing else 'off'}.")
        elif cmd == "\\i" and len(parts) > 1:
            try:
                with open(parts[1]) as fh:
                    for stmt in split_statements(fh.read()):
                        self.run_sql(stmt)
            except OSError as e:
                self._print(f"ERROR: {e}")
        elif cmd == "\\ingest" and len(parts) > 1:
            try:
                with open(parts[1]) as fh:
                    cfg = json.load(fh)
                stats = kafka_ingest(self.host, cfg, token=self.token)
                self._print(f"ingested {stats['records']} records "
                            f"({stats['batches']} batches) into "
                            f"{cfg['index']}")
            except Exception as e:  # noqa: BLE001 — shell surfaces errors
                self._print(f"ERROR: {e}")
        else:
            self._print(f"unknown command: {cmd}")
        return True

    def feed(self, line: str) -> bool:
        """Feed one input line; returns False when the shell should exit."""
        stripped = line.strip()
        if not self._buf and stripped.startswith("\\"):
            return self.meta(stripped)
        if not stripped and not self._buf:
            return True
        self._buf.append(line)
        text = "\n".join(self._buf)
        if stripped.endswith(";"):
            self._buf = []
            for stmt in split_statements(text):
                self.run_sql(stmt)
        return True

    def prompt(self) -> str:
        return "fbsql> " if not self._buf else "  ...> "

    def interact(self, in_stream=None):
        interactive = in_stream is None and sys.stdin.isatty()
        stream = in_stream or sys.stdin
        if interactive:
            try:
                import readline  # noqa: F401 — history/line editing
            except ImportError:
                pass
            self._print(f"fbsql connected to {self.host} "
                        "(\\q to quit, \\dt tables, \\timing)")
        while True:
            if interactive:
                try:
                    line = input(self.prompt())
                except (EOFError, KeyboardInterrupt):
                    break
            else:
                line = stream.readline()
                if not line:
                    # flush any unterminated trailing statement
                    if self._buf:
                        for stmt in split_statements("\n".join(self._buf)):
                            self.run_sql(stmt)
                    break
                line = line.rstrip("\n")
            if not self.feed(line):
                break


def split_statements(text: str) -> List[str]:
    """Split on ';' outside quotes; drops empty statements."""
    out, cur, quote = [], [], None
    for ch in text:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
            cur.append(ch)
        elif ch == ";":
            stmt = "".join(cur).strip()
            if stmt:
                out.append(stmt)
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out
