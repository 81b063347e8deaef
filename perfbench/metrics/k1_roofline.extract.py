"""K1's share of its roofline over the traced window."""

from perfbench.metrics.layer import k1_roofline


def read(ctx):
    return k1_roofline(ctx)
