"""Percent of the stacked-leaf gathers that miss the leaf cache: the count
of the span `storage.upload` (a leaf's upload on a miss) over that of
`storage.leaf`.  A fragment mirror's upload is `storage.mirror_upload` and
counts in neither."""
from portbench.metrics import spans


def read(ctx):
    t = spans.totals()
    if t is None or not t.get("storage.leaf", {}).get("count"):
        return None
    up = t.get("storage.upload", {}).get("count", 0)
    return 100.0 * up / t["storage.leaf"]["count"]
