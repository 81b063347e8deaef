"""Device ms a training step spends in K1's backward (the program's
span ``k1.backward``, one a frame: the plain recompute and its autograd),
over the traced window's steps."""

from perfbench.metrics.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "k1.backward")
