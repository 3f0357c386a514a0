"""95th percentile latency of the window's queries
(portbench/metrics/latency.py)."""
from portbench.metrics import latency


def read(ctx):
    return latency.percentile(ctx, 95)
