"""The device's idle share of the traced window."""

from perfbench.metrics.layer import device_idle


def read(ctx):
    return device_idle(ctx)
