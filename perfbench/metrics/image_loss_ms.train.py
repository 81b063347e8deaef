"""Device ms a training step spends in SlotFormer's image loss (the
program's span ``slotformer.image_loss``: on the chunked branch the decode
and its input gradient, chunk by chunk), over the traced window's steps."""

from perfbench.metrics.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "slotformer.image_loss")
