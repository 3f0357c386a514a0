"""The port's span totals over the traced window, a query: the totals of
featurebase_tpu_torch/utils/tracing.py's TRACER, which it keeps only while
torch.profiler records (the window alone; set-up and warm-up run without
it).  A program without them reads as nothing."""


def totals():
    """TRACER.totals(), or None where the program keeps none."""
    from featurebase_tpu_torch.utils.tracing import TRACER
    read = getattr(TRACER, "totals", None)
    got = read() if read is not None else None
    return got or None


def per_query_ms(ctx, names=(), prefixes=(), key="self_ns"):
    """The `key` nanoseconds of the spans named in `names` or starting with
    one of `prefixes`, summed, in ms a query of the window."""
    t = totals()
    n = len(ctx.window.records)
    if t is None or n == 0:
        return None
    ns = sum(v[key] for name, v in t.items()
             if name in names or name.startswith(tuple(prefixes)))
    return ns / n / 1e6
