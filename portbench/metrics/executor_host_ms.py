"""Host time of the executor a query (executor/executor.py, plan.py): the
self time of the spans `executor.execute<Call>`, `plan.compile` and
`plan.lower`, in ms."""
from portbench.metrics import spans


def read(ctx):
    return spans.per_query_ms(ctx, names=("plan.compile", "plan.lower"),
                              prefixes=("executor.execute",))
