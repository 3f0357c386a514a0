"""The port's kernel launches (ops/cuda_kernels.py's launch counters) over
the window, a query."""


def read(ctx):
    if not ctx.window.records or ctx.launches is None:
        return None
    return sum(ctx.launches.values()) / len(ctx.window.records)
