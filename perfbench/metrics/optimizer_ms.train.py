"""Device ms a training step spends in the optimizer (CUDA events around the
call, recorded by the benchmark in traced runs), averaged over the window."""

from perfbench.metrics.layer import span_mean


def read(ctx):
    return span_mean(ctx, "optimizer")
