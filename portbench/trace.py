"""The reduction of a torch.profiler trace of the window.

Device work belongs to a query family (a GroupBy, a Sum, a Count) through
the profiler's launch correlation, never through device timestamps:

- a launch made inside a torch op links to that op, and so to the query
  label on the op's thread that holds it;
- a launch made by the port's own ctypes calls has no op around it, only
  its runtime call; it belongs to the family of the labels that hold the
  call, where they are all of one family (in a closed loop every client's
  label is nearly always open, so a thread cannot be told from time alone).

The window is the span of the "portbench:window" label; the device is busy
where any kernel, copy or memset runs (their union), clipped to it.  An
idle gap is named by what the host was doing for the query whose launch
ends it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Host events that are runtime calls, not work of the program's own.
_RUNTIME = ("cuda", "cu")

WINDOW = "portbench:window"

# The port's kernels' symbols by launch counter name (ops/cuda_kernels.py's
# KERNELS): f"{name}_kernel", but for kernel H's two modes.
KERNEL_SYMBOLS = {"var_moments": "moments_kernel<1,",
                  "corr_moments": "moments_kernel<2,"}


def kernel_symbol(name: str) -> str:
    return KERNEL_SYMBOLS.get(name, f"{name}_kernel")


def label(query, client: int, seq: int) -> str:
    return f"q|{client}|{seq}"


def _is_label(name: str) -> bool:
    return name.startswith("q|") or name == WINDOW


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0][:96]


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_s_by_family: Dict[str, float]
    unlinked_s: float
    device_ops: List[list]
    idle_gaps: List[list]
    kernels_seen: Dict[str, int] = field(default_factory=dict)
    events: int = 0


def reduce(prof, kernel_names, queries: Dict[Tuple[int, int], tuple]
           ) -> Summary:
    """`queries` maps a label's (client, seq) to (template, family)."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    op_at: Dict[int, Tuple[int, int]] = {}   # op or label -> (tid, start)
    rt_at: Dict[int, int] = {}               # runtime call -> start
    labels = defaultdict(list)     # tid -> [(start, end, (client, seq))]
    host_ops = defaultdict(list)   # tid -> [(start, end, name)]
    window = None
    device = []
    for e in evs:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            st, en, tid = e.start_ns(), e.end_ns(), e.start_thread_id()
            if name.startswith(_RUNTIME):
                rt_at[e.correlation_id()] = st
                continue
            op_at[e.correlation_id()] = (tid, st)
            if name.startswith("q|"):
                _, c, s = name.split("|")
                labels[tid].append((st, en, (int(c), int(s))))
            elif name == WINDOW:
                window = (st, en)
            else:
                host_ops[tid].append((st, en, name))
        elif not _is_label(name):
            # kernels, copies and memsets (not the labels' device spans)
            device.append((name, e.start_ns(), e.end_ns(),
                           e.linked_correlation_id(), e.correlation_id()))
    if window is None:
        raise RuntimeError("the trace holds no window label")
    w0, w1 = window
    for ls in list(labels.values()) + list(host_ops.values()):
        ls.sort()
    starts = {tid: [x[0] for x in ls] for tid, ls in labels.items()}

    def holding(tid, t):
        i = bisect.bisect_right(starts[tid], t) - 1
        if i >= 0 and labels[tid][i][1] >= t:
            return queries.get(labels[tid][i][2])
        return None

    def launcher(lc, cid) -> Optional[tuple]:
        """(thread or None, (template or None, family)) of a launch."""
        if lc in op_at:
            tid, t = op_at[lc]
            q = holding(tid, t) if tid in labels else None
            return (tid, q) if q is not None else None
        if cid in rt_at:
            held = {q for tid in labels
                    if (q := holding(tid, rt_at[cid])) is not None}
            families = {f for _, f in held}
            if len(families) == 1:
                tmpl = {t for t, _ in held}
                return None, (tmpl.pop() if len(tmpl) == 1 else None,
                              families.pop())
        return None

    by_family: Dict[str, float] = defaultdict(float)
    unlinked = 0
    by_name: Dict[str, int] = defaultdict(int)
    seen = {k: 0 for k in kernel_names}
    spans = []                     # (start, end, launcher)
    for name, st, en, lc, cid in device:
        for k in kernel_names:
            if kernel_symbol(k) in name:
                seen[k] += 1
        who = launcher(lc, cid)
        if who is None:
            unlinked += en - st
        else:
            by_family[who[1][1]] += (en - st) / 1e9
        s, e = max(st, w0), min(en, w1)
        if e > s:
            spans.append((s, e, who))
            by_name[_short(name)] += e - s
    spans.sort(key=lambda x: x[0])
    busy_ns, gaps, prev = 0, [], w0
    for s, e, who in spans + [(w1, w1, None)]:
        if s > prev:
            gaps.append((s - prev, prev, s, who))
        if e > prev:
            busy_ns += e - max(s, prev)
            prev = e
    gaps.sort(key=lambda g: -g[0])
    gap_names: Dict[str, int] = defaultdict(int)
    for dur, s, e, who in gaps[:256]:
        gap_names[_host_doing((s + e) // 2, who, host_ops)] += dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gap_names.items(), key=lambda kv: -kv[1])[:10]
    return Summary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                   device_s_by_family=dict(by_family),
                   unlinked_s=unlinked / 1e9,
                   device_ops=[[n, v / 1e9] for n, v in top],
                   idle_gaps=[[n, v / 1e9] for n, v in idle],
                   kernels_seen=seen, events=len(evs))


def _host_doing(t: int, who, host_ops) -> str:
    """What the host was doing at time t, in an idle gap of the device:
    the template of the query whose launch ends the gap and, where the
    launching thread is known, its innermost op at t or Python between
    ops."""
    if who is None:
        return "host: no query's launch ends the gap"
    tid, (template, family) = who
    if tid is None:
        return f"host: {template or family} (its thread unknown)"
    ops = host_ops.get(tid, [])
    j = bisect.bisect_right(ops, (t, float("inf"), "")) - 1
    inner = "python"
    for k in range(j, max(j - 64, -1), -1):
        if ops[k][1] >= t:
            inner = ops[k][2]
            break
    return f"host: {template} {inner}"
