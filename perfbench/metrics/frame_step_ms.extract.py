"""Device ms of one frame step of the temporal encode (the program's span
``savi.frame_step``: the predictor, the kernel noise and K1), the mean over
the traced window."""

from perfbench.metrics.spans import device_ms_mean


def read(ctx):
    return device_ms_mean(ctx, "savi.frame_step")
