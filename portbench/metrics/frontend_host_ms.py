"""Host time of the front end a query (server/api.py): the self time of
the spans `query` and `query.parse`, in ms."""
from portbench.metrics import spans


def read(ctx):
    return spans.per_query_ms(ctx, names=("query", "query.parse"))
