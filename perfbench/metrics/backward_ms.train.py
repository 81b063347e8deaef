"""Device ms of a training step from the end of ``model.train_loss`` to
the start of ``optimizer.step`` (CUDA events the benchmark records in
traced runs): the loss sum and the backward, averaged over the window."""

from perfbench.metrics.layer import span_mean


def read(ctx):
    return span_mean(ctx, "backward")
