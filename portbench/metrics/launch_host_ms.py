"""Host time of the kernels' launch wrappers a query
(ops/cuda_kernels.py): the self time of the spans `kernel.<name>`, in
ms."""
from portbench.metrics import spans


def read(ctx):
    return spans.per_query_ms(ctx, prefixes=("kernel.",))
