"""The closed loop: `clients` threads, each sending its next query when its
last one is answered, for a window of fixed length on the host's clock.

A query is in the window when it was sent before the window's end; each is
awaited.  Latency runs from the client's send to the answer; the answer of a query kept for the check is reduced by `keep`
after that.  With
`label`, each query runs under torch.profiler.record_function(label(...))
and the window under "portbench:window", for the trace's reduction.
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional


@dataclass
class Record:
    client: int
    seq: int
    query: object          # traffic.Query
    sent: float            # perf_counter seconds
    done: float
    error: Optional[str]
    answer: object = None  # keep(query, result) of a query kept for the
                           # check, taken after `done`


@dataclass
class Window:
    records: List[Record]
    start: float
    end: float             # start + seconds
    last_done: float


def run(send: Callable[[str], object], streams: List[Iterator],
        seconds: float, keep: Callable, label: Optional[Callable] = None
        ) -> Window:
    n = len(streams)
    per_client: List[List[Record]] = [[] for _ in range(n)]
    errors: List[BaseException] = []
    times = {}
    gate = threading.Barrier(n + 1)
    if label is not None:
        from torch.profiler import record_function

    def client(ci: int):
        out = per_client[ci]
        try:
            gate.wait()
            end = times["end"]
            for seq, q in enumerate(streams[ci]):
                ctx = record_function(label(q, ci, seq)) \
                    if label is not None else nullcontext()
                sent = time.perf_counter()
                if sent >= end:
                    break
                err, res = None, None
                with ctx:
                    try:
                        res = send(q.pql)
                    except Exception as e:  # noqa: BLE001 - a failed query
                        err = f"{type(e).__name__}: {e}"
                done = time.perf_counter()
                ans = keep(q, res) if q.check and err is None else None
                out.append(Record(ci, seq, q, sent, done, err, ans))
        except BaseException as e:  # noqa: BLE001 - re-raised by run()
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,),
                                name=f"portbench-client-{i}")
               for i in range(n)]
    for t in threads:
        t.start()
    win = record_function("portbench:window") if label is not None \
        else nullcontext()
    with win:
        times["start"] = time.perf_counter()
        times["end"] = times["start"] + seconds
        gate.wait()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    records = sorted((r for rs in per_client for r in rs),
                     key=lambda r: r.sent)
    last = max((r.done for r in records), default=times["end"])
    return Window(records, times["start"], times["end"], last)
