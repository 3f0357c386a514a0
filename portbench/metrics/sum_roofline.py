"""Percent of the HBM bound (portbench/metrics/roofline.py) that the
window's Sum queries reach over the device time linked to them."""
from portbench.metrics import roofline


def read(ctx):
    return roofline.share(ctx, "sum")
