"""Helpers the traffic kinds share: the measured window, the profiler
around it, and the CUDA-event spans of a traced run."""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional

import torch

MARKER = "perfbench.window"


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """Runs ``step(i)`` for ``i`` = 0, 1, ... until ``seconds`` have passed,
    then waits for the device; with ``trace`` under ``torch.profiler`` and
    a host span ``MARKER`` around the steps."""

    def __init__(self, device, seconds: float, trace: bool):
        self.device, self.seconds, self.trace = device, seconds, trace
        self.steps = 0
        self.elapsed = 0.0
        self.prof = None

    def run(self, step: Callable[[int], None]) -> "Window":
        synchronize(self.device)
        prof = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            with torch.profiler.record_function(MARKER):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < self.seconds:
                    step(self.steps)
                    self.steps += 1
                synchronize(self.device)
                self.elapsed = time.perf_counter() - t0
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        self.prof = prof
        return self


def sampled_window(job, call: Callable[[int], object]):
    """The window over ``call(i)``, keeping the answers of a sample of the
    calls drawn from the seed (each with chance ``sample_share``, at most
    ``max_samples``; the first and the last call always): (window, {i:
    answer})."""
    import numpy as np

    t = job.cell.traffic
    rng = np.random.default_rng(job.seed)
    kept, last = {}, []

    def step(i):
        answer = call(i)
        if not kept or (rng.random() < float(t["sample_share"])
                        and len(kept) < int(t["max_samples"])):
            kept[i] = answer
        last[:] = [(i, answer)]

    win = Window(job.device, job.seconds, job.trace).run(step)
    kept.update(last)
    return win, kept


class Spans:
    """CUDA-event spans around calls, by name: ``wrap(obj, attr, name)``
    replaces ``obj.attr`` on the instance by a call between two events."""

    def __init__(self):
        self.events: Dict[str, List[tuple]] = {}

    def wrap(self, obj, attr: str, name: str) -> None:
        inner = getattr(obj, attr)
        events = self.events.setdefault(name, [])

        def timed(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(*args, **kwargs)
            e1.record()
            events.append((e0, e1))
            return out

        setattr(obj, attr, timed)

    def between(self, start: str, end: str) -> List[float]:
        """ms from each ``start`` span's end to the next ``end`` span's
        start (the i-th of each)."""
        return [a[1].elapsed_time(b[0])
                for a, b in zip(self.events.get(start, ()),
                                self.events.get(end, ()))]

    def ms(self, name: str) -> List[float]:
        return [e0.elapsed_time(e1) for e0, e1 in self.events.get(name, ())]


def mean(xs) -> Optional[float]:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def peak_bytes(device) -> int:
    """Bytes of device memory allocated at most since the last reset."""
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


@contextmanager
def precision(mode: str, device):
    """Run the reference in ``mode``: ``float32`` (TF32 off), ``tf32``
    (TF32 on for matrix products and convolutions: the control of a
    float32 cell on the card), ``bfloat16`` (autocast: a lower precision
    the CPU has) or ``bfloat16_pure`` (TF32 off and no autocast here: the
    caller holds the weights, inputs and Adam's state in bfloat16, the
    control of a bfloat16 cell)."""
    if mode not in ("float32", "tf32", "bfloat16", "bfloat16_pure"):
        raise ValueError(f"precision {mode!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    cast = (torch.autocast(torch.device(device).type, dtype=torch.bfloat16)
            if mode == "bfloat16" else nullcontext())
    try:
        with cast:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
