"""Host time of the aggregate finish a query (finalize_sum, finish_groups
and the result's wrapping): the self time of the span `agg.finish`, in
ms."""
from portbench.metrics import spans


def read(ctx):
    return spans.per_query_ms(ctx, names=("agg.finish",))
