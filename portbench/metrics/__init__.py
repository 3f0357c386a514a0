"""Metric readers, one module a metric of BENCHMARK.json, named as the
metric (loaded by path: a name may hold dots).  Each has ``read(ctx)``,
which returns the metric's value or None where it finds nothing to read;
``ctx`` is run.Context."""
