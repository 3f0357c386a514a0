"""Run one benchmark cell of BENCHMARK.json against the port,
featurebase_tpu_torch, and print its result as the last line of standard
output.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell names a configuration (portbench/configs/), a traffic mix
(portbench/traffic/) and its chips.  Set-up makes the configuration's table
on the card from the seed (portbench/load.py), wraps it in the port's
in-memory API and warms the mix's query shapes; then the mix's clients run
a closed loop against ``API.query`` for --seconds (portbench/loop.py), under
torch.profiler with --trace 1.  After the window the port's state is freed
and the plain reference (portbench/reference/) answers the queries kept
for the check from the same columns, made again from the seed.  Metrics are
read by the modules of portbench/metrics/ named as in BENCHMARK.json: the
cell's end-to-end metrics with --trace 0, its per-layer metrics with
--trace 1.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "portbench")
CACHE = os.path.join(ROOT, ".portbench-cache")

# Kernel caches at fixed paths inside the checkout; the port's defaults for
# everything else (its nvcc builds go to featurebase_tpu_torch/build/).
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
for _k in [k for k in os.environ if k.startswith("FEATUREBASE_TPU_")]:
    del os.environ[_k]

# Top-level module names that no run may load (compared whole).
BANNED = ("jax", "jaxlib", "flax", "featurebase_tpu")


class NoDevice(SystemExit):
    pass


@dataclass
class Context:
    """What the metric readers read."""
    cfg: dict
    mix: dict
    window: object            # loop.Window
    setup_s: float
    trace: object = None      # trace.Summary, with --trace 1
    launches: Optional[Dict[str, int]] = None
    residency: Optional[tuple] = None
    stored: Optional[dict] = None   # shards a row (load.build)


def reader(name: str):
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m["workloads"] or "workloads" not in m
            and m["moves"] in names]


def require_devices(chips: int):
    """The card, or exit without a result."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), "
              f"{n} available", file=sys.stderr)
        raise NoDevice(2)
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def _host_ram_gib() -> float:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2**30


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             device, shards: Optional[int] = None) -> dict:
    """One run of `cell`; `shards` cuts the configuration (tests only)."""
    import torch

    from featurebase_tpu_torch.ops import cuda_kernels as ck
    from featurebase_tpu_torch.server.api import API
    from featurebase_tpu_torch.storage.residency import reset as \
        reset_residency
    from featurebase_tpu_torch.storage.residency import residency
    from portbench import compare, datagen, load, loop, spec, traffic
    from portbench import trace as tr
    from portbench.reference.answers import answers

    wl, cfg, mix = spec.cell(bench, cell, shards)
    notes = {"host_ram_gib": round(_host_ram_gib(), 1)}

    t = time.perf_counter()
    stored = {}
    holder = load.build(cfg, seed, device, stored)
    notes["build_s"] = time.perf_counter() - t
    api = API(holder=holder, device=device)
    t = time.perf_counter()
    for q in traffic.warm_queries(mix, cfg):
        api.query(cfg["index"], q.pql)
    if device.type == "cuda":
        torch.cuda.synchronize()
    notes["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START
    notes["setup_s"] = setup_s
    notes["resident_bytes"] = residency().stats()["bytes"]

    streams = [traffic.stream(mix, cfg, seed, c)
               for c in range(int(mix["clients"]))]

    def send(pql):
        return api.query(cfg["index"], pql)[0]

    def keep(query, result):
        return compare.canonical(traffic.thaw(query.spec), result)

    res0 = residency().stats()
    l0 = ck.launches()
    prof = None
    if trace:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # the clients' threads are traced too (their query labels)
        prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
        prof.__enter__()
    try:
        window = loop.run(send, streams, seconds, keep,
                          label=tr.label if trace else None)
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    l1 = ck.launches()
    res1 = residency().stats()
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    ctx = Context(cfg, mix, window, setup_s,
                  launches={k: l1[k] - l0[k] for k in l1},
                  residency=(res0, res1), stored=stored)
    summary = None
    if prof is not None:
        t = time.perf_counter()
        summary = tr.reduce(prof, list(l1), {
            (r.client, r.seq): (r.query.template,
                                traffic.family(traffic.thaw(r.query.spec)))
            for r in window.records})
        del prof
        ctx.trace = summary
        notes["trace_reduce_s"] = time.perf_counter() - t
        notes["trace_events"] = summary.events
        notes["trace_unlinked_device_s"] = summary.unlinked_s
        lost = {k: l1[k] - l0[k] - summary.kernels_seen.get(k, 0)
                for k in l1 if l1[k] - l0[k]}
        notes["trace_launches_not_seen"] = {k: v for k, v in lost.items()
                                            if v}
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        v = reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # free the port's state before the reference runs on the card
    holder.delete_index(cfg["index"])
    del api, holder, send
    reset_residency()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    specs = sorted({r.query.spec for r in window.records
                    if r.answer is not None})
    queries = [traffic.thaw(s) for s in specs]
    ref = {s: compare.reference_form(q, a) for s, q, a in zip(
        specs, queries, answers(cfg, queries, (
            cols for *_, cols in datagen.iter_chunks(cfg, seed, device))))}
    notes["reference_s"] = time.perf_counter() - t
    checks = compare.checks(window.records, ref)
    correct = all(compare.passed(c) for c in checks)

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        notes["power"] = _power_limit()
    out = {"correct": correct, "attempted": len(window.records),
           "failed": sum(1 for r in window.records if r.error is not None),
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    by_t = {}
    for r in window.records:
        by_t.setdefault(r.query.template, []).append(r.done - r.sent)
    notes["p50_ms_by_template"] = {
        k: [len(v), 1e3 * sorted(v)[len(v) // 2]] for k, v in by_t.items()}
    errs = [r.error for r in window.records if r.error is not None]
    if errs:
        notes["first_error"] = errs[0][:500]
    out["notes"] = notes
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"],
                                 "op": c["op"]} for c in checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import spec
    bench = spec.benchmark()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    try:
        device = require_devices(int(cell["chips"]))
    except NoDevice as e:
        return int(e.code)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), device)
    found = banned_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(out["notes"], default=str), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} {c['op']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
