"""Latency percentiles of every query sent in the window, from the send to
the answer, in ms (numpy's linear interpolation between order statistics)."""
import numpy as np


def percentile(ctx, p: float):
    lat = [r.done - r.sent for r in ctx.window.records]
    if not lat:
        return None
    return 1e3 * float(np.percentile(np.array(lat), p))
