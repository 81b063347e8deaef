"""The program's own spans in a traced run's window (the ``record_function``
ranges of ``slotformer_tpu_torch/trace.py``), reduced once a run
and kept on ``ctx`` as ``program_spans``. For each span name:

* ``host_intervals``: its host intervals, clipped to the window;
* ``device``: for each host interval, the device range of the work launched
  inside it: from the first start to the last end of the kernels, copies
  and sets whose launching call of CUDA's runtime or driver (linked by
  correlation id) starts inside the interval, on any thread;
* ``busy_ns(ranges)``: the device's busy time inside those ranges, from
  ``ctx.trace.busy``.

Kineto's own device-side mirror of a span is not used: it covers the work
launched while the span is open on its own thread, and SlotFormer's image
loss launches its chunks' gradients from the autograd engine's device
thread (its mirror came in three overlapping pieces a step on the card).

A program without the span (an older one) gives empty lists, and the
readers then return None; so do the device readers on a run without a
card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from perfbench.core import _annotation, _union

Interval = Tuple[int, int]
# the program's spans
NAMES = ("step.forward", "step.backward", "step.optimizer",
         "slotformer.image_loss", "slotformer.rollouter", "savi.frame_step",
         "k1.backward", "extract.load")


class Spans:
    """Host intervals and device ranges by span name (see the module)."""

    def __init__(self, events, window: Interval, busy: List[Interval]):
        from torch.autograd import DeviceType

        cuda = DeviceType.CUDA
        w0, w1 = window
        host: Dict[str, List[Interval]] = {n: [] for n in NAMES}
        launch_at: Dict[int, int] = {}
        # one pass over what may be millions of events, asking each for as
        # little as it can: the spans, and the calls of CUDA's runtime and
        # driver (``cuda*``, ``cu*``; an op is ``<namespace>::<op>``), by
        # name; what may be device activity (not an ``aten::`` op) is kept
        # and linked after the pass, where a launch has its correlation id
        maybe = []
        for e in events:
            name = e.name()
            if name in host:
                if e.device_type() != cuda:  # not the span's device mirror
                    s = e.start_ns()
                    host[name].append((s, s + e.duration_ns()))
            elif name[:2] == "cu" and e.device_type() != cuda:
                launch_at[e.correlation_id()] = e.start_ns()
            elif not name.startswith("aten::"):
                maybe.append(e)
        launch_at.pop(0, None)
        linked = []
        for e in maybe:
            c = e.correlation_id()
            if c in launch_at and e.device_type() == cuda and not _annotation(e):
                s = e.start_ns()
                linked.append((launch_at[c], s, s + e.duration_ns()))
        linked.sort()
        self.window = (w0, w1)
        self._host = {n: _clip(iv, w0, w1) for n, iv in host.items()}
        self._launch = np.array([x[0] for x in linked], dtype=np.int64)
        self._dev_start = np.array([x[1] for x in linked], dtype=np.int64)
        self._dev_end = np.array([x[2] for x in linked], dtype=np.int64)
        self._busy_start = np.array([s for s, _ in busy], dtype=np.int64)
        self._busy_end = np.array([e for _, e in busy], dtype=np.int64)

    def host_intervals(self, name: str) -> List[Interval]:
        return self._host.get(name, [])

    def device(self, name: str) -> List[Interval]:
        """The device range of each of the span's host intervals that
        launched device work, clipped to the window."""
        w0, w1 = self.window
        out = []
        for s, e in self.host_intervals(name):
            i0 = np.searchsorted(self._launch, s, side="left")
            i1 = np.searchsorted(self._launch, e, side="right")
            if i1 > i0:
                a = max(int(self._dev_start[i0:i1].min()), w0)
                b = min(int(self._dev_end[i0:i1].max()), w1)
                if b > a:
                    out.append((a, b))
        return out

    def busy_ns(self, ranges: List[Interval]) -> int:
        """Device busy time inside ``ranges`` (their union)."""
        total = 0
        for r0, r1 in _merged(ranges):
            i0 = np.searchsorted(self._busy_end, r0, side="right")
            i1 = np.searchsorted(self._busy_start, r1, side="left")
            if i1 > i0:
                total += int((np.minimum(self._busy_end[i0:i1], r1)
                              - np.maximum(self._busy_start[i0:i1], r0)).sum())
        return total


def spans(ctx) -> Optional[Spans]:
    """The run's ``Spans``, made at the first call; None without a trace."""
    if getattr(ctx, "trace", None) is None:
        return None
    if getattr(ctx, "program_spans", None) is None:
        events = ctx.window.prof.profiler.kineto_results.events()
        ctx.program_spans = Spans(events, ctx.trace.window_ns, ctx.trace.busy)
    return ctx.program_spans


def _device(ctx, name: str) -> List[Interval]:
    sp = spans(ctx)
    return sp.device(name) if sp is not None else []


def device_ms_per_call(ctx, name: str) -> Optional[float]:
    """Device ms in the span's ranges over the window's calls."""
    ranges = _device(ctx, name)
    if not ranges or not ctx.steps:
        return None
    return sum(b - a for a, b in ranges) * 1e-6 / ctx.steps


def device_ms_mean(ctx, name: str) -> Optional[float]:
    """Mean ms of one of the span's device ranges."""
    ranges = _device(ctx, name)
    if not ranges:
        return None
    return sum(b - a for a, b in ranges) * 1e-6 / len(ranges)


def device_idle(ctx, name: str) -> Optional[float]:
    """% of the span's device ranges in which no kernel, copy or set ran."""
    ranges = _device(ctx, name)
    length = sum(b - a for a, b in _merged(ranges))
    if not length:
        return None
    return 100.0 * (1.0 - spans(ctx).busy_ns(ranges) / length)


def host_ms_per_call(ctx, name: str) -> Optional[float]:
    """Host ms in the span over the window's calls."""
    sp = spans(ctx)
    intervals = sp.host_intervals(name) if sp is not None else []
    if not intervals or not ctx.steps:
        return None
    return sum(b - a for a, b in intervals) * 1e-6 / ctx.steps


def _clip(intervals: List[Interval], w0: int, w1: int) -> List[Interval]:
    return sorted((max(s, w0), min(e, w1)) for s, e in intervals
                  if e > w0 and s < w1)



def _merged(ranges: List[Interval]) -> List[Interval]:
    """The union of ``ranges``, by ``core._union``."""
    return _union([(a, b, None) for a, b in ranges])
