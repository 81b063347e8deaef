"""Device ms a call of the traced window spends in the kernels whose name
holds a given pattern, for the readers of one kernel's time."""

from __future__ import annotations

from typing import Optional


def kernel_ms_per_call(ctx, pattern: str) -> Optional[float]:
    """Device ms per call of the window in kernels named ``*pattern*``;
    None where no such kernel ran."""
    if ctx.trace is None or not ctx.steps:
        return None
    seconds = ctx.trace.kernel_seconds(pattern)
    if seconds <= 0:
        return None
    return 1e3 * seconds / ctx.steps
