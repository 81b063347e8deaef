"""The whole step's share of the device's peak in the configuration's
precision."""

from perfbench.metrics.layer import mfu


def read(ctx):
    return mfu(ctx)
