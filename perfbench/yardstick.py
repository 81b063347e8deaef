"""The benchmark's yardstick: the table of peaks, the least time of kernel
K1's work, and the operations of a step counted over the reference.

These counts belong to the benchmark: a change to how the program does
the work does not change them."""

from __future__ import annotations

import json
from typing import Optional, Tuple

from .core import BENCH


def peaks(device_kind: str) -> Optional[dict]:
    """The published peaks of ``device_kind`` (``torch.cuda.get_device_name``),
    or None for a device the table does not hold."""
    return json.loads((BENCH / "peaks.json").read_text()).get(device_kind)


def k1_work(B: int, N: int, D: int, S: int, H: int, iters: int) -> Tuple[int, int]:
    """(bytes, FLOPs) of one call of the slot-attention loop: k and v
    [B, N, D] and the slots read once, the weights (q projection, the GRU's
    two 3D-wide matrices, the MLP, nine D-vectors) read once, the slots and
    the last round's attention [B, N, S] written once; per round the logits
    and the weighted sum (2 x 2BNSD), the q projection (2BSD^2), the GRU
    (12BSD^2) and the MLP (4BSDH)."""
    weights = D * D + 6 * D * D + 2 * D * H + H + 9 * D
    nbytes = 4 * (2 * B * N * D + B * S * D + weights + B * S * D + B * N * S)
    flops = iters * (4 * B * N * S * D + 2 * B * S * D * D
                     + 12 * B * S * D * D + 4 * B * S * D * H)
    return nbytes, flops


def k1_bound_s(shape: dict, peak: dict) -> Tuple[float, str]:
    """Least seconds of one K1 call on a device of ``peak``, and whether
    bytes or operations set it."""
    nbytes, flops = k1_work(shape["B"], shape["N"], shape["D"], shape["S"],
                            shape["H"], shape["iters"])
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    t_ops = flops / peak["float32_flop_per_s"]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def count_flops(fn) -> int:
    """FLOPs of ``fn()`` by ``torch.utils.flop_counter.FlopCounterMode``
    (matrix products, convolutions and attention, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())
