"""The whole step's share of the device's float32 peak."""

from perfbench.metrics.layer import mfu


def read(ctx):
    return mfu(ctx)
