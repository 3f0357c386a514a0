"""Time the host waits for the card a query: the duration of the span
`device.wait` (the results' copies to the host), in ms."""
from portbench.metrics import spans


def read(ctx):
    return spans.per_query_ms(ctx, names=("device.wait",), key="wall_ns")
