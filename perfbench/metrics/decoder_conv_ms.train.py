"""Device ms a training step spends in kernel K3, the decoder's 5x5 stride-1
layer (kernels named ``decoder_conv_s1*``: its forward and its input
gradient), over the traced window's steps; None where no such kernel ran."""

from perfbench.metrics.kernel_ms import kernel_ms_per_call


def read(ctx):
    return kernel_ms_per_call(ctx, "decoder_conv_s1")
