"""% of the rollouter's device ranges (the program's span
``slotformer.rollouter``) in which no kernel, copy or set ran on the
device."""

from perfbench.metrics.spans import device_idle


def read(ctx):
    return device_idle(ctx, "slotformer.rollouter")
