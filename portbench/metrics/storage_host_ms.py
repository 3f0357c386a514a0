"""Host time of the storage layer a query (the stacked leaves of
executor/plan.py and the fragments' mirrors): the self time of the spans
`storage.leaf`, `storage.upload` and `storage.mirror_upload`, in ms."""
from portbench.metrics import spans


def read(ctx):
    return spans.per_query_ms(ctx, names=("storage.leaf", "storage.upload",
                                          "storage.mirror_upload"))
