"""Device ms a rollout call spends in the rollouter's autoregressive passes
(the program's span ``slotformer.rollouter``), over the traced window's
calls."""

from perfbench.metrics.spans import device_ms_per_call


def read(ctx):
    return device_ms_per_call(ctx, "slotformer.rollouter")
