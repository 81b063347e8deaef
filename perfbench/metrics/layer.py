"""What the per-layer readers share. A reader is ``metrics/<metric>.py``
with ``read(ctx) -> float | None``; ``ctx`` (a traced run's) holds
``trace`` (``core.Trace``), ``steps`` (calls in the traced window),
``spans`` (ms by span name), ``flops_per_step()`` (the reference's count),
``k1_calls`` ([(shape, calls)]), ``peak`` (the device's row of
``peaks.json``, or None) and ``precision`` (the configuration's, the
program's arithmetic: ``float32`` or ``bfloat16``). A reader that finds
nothing returns None."""

from __future__ import annotations

from typing import Optional

from perfbench.yardstick import k1_bound_s


def span_mean(ctx, name: str) -> Optional[float]:
    xs = ctx.spans.get(name) or []
    return sum(xs) / len(xs) if xs else None


def k1_roofline(ctx) -> Optional[float]:
    """% of K1's device time that its least time takes: the least time of
    each call the cell's work needs, over the time of the kernels named
    ``fused_slot_attention*`` in the traced window."""
    if ctx.trace is None or ctx.peak is None or not ctx.k1_calls:
        return None
    seconds = ctx.trace.kernel_seconds("fused_slot_attention")
    if seconds <= 0:
        return None
    bound = sum(n * k1_bound_s(shape, ctx.peak)[0] for shape, n in ctx.k1_calls)
    return 100.0 * bound / seconds


def mfu(ctx) -> Optional[float]:
    """% of the device's peak in the configuration's precision (float32's,
    or bfloat16's for a cell trained under bf16 autocast): the reference's
    FLOPs of a call times the calls of the traced window, over the window."""
    if ctx.trace is None or ctx.peak is None or not ctx.steps:
        return None
    flops = ctx.flops_per_step()
    if not flops:
        return None
    peak = ctx.peak[f"{ctx.precision}_flop_per_s"]
    return 100.0 * flops * ctx.steps / ctx.trace.window_s / peak


def device_idle(ctx) -> Optional[float]:
    """% of the traced window in which no operation ran on the device (the
    union of the device's kernel, copy and set intervals)."""
    if ctx.trace is None or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
