"""Percent of the stacked-leaf checks that fell back to the walk of their
fragments: the count of the counter `storage.leaf_walk` (a check whose
write clock had moved, or whose pin had) over that of the span
`storage.leaf`.  A program without the counter (no TRACER.count) reads as
nothing."""
from portbench.metrics import spans


def read(ctx):
    from featurebase_tpu_torch.utils.tracing import TRACER
    if getattr(TRACER, "count", None) is None:
        return None
    t = spans.totals()
    if t is None or not t.get("storage.leaf", {}).get("count"):
        return None
    walks = t.get("storage.leaf_walk", {}).get("count", 0)
    return 100.0 * walks / t["storage.leaf"]["count"]
