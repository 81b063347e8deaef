"""Host ms an extraction call spends reading and stacking its batch of
videos (the program's span ``extract.load``), over the traced window's
calls."""

from perfbench.metrics.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx, "extract.load")
