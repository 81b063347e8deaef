"""Streaming metric meters: a copy of ``slotformer_tpu/runtime/meters.py``.

Replaces ``nerv.utils.AverageMeter`` / ``MeanMetric`` (reference usage:
test_vp.py:128-131 keeps one meter per metric per rollout step;
clevrer_vqa/method.py:62-112 aggregates over two batch-size domains).
Values may be python floats, numpy scalars or 0-d tensors; everything is
pulled to a host float so meters never retain device buffers.
"""

from __future__ import annotations

from typing import Dict


def _to_float(v) -> float:
    try:
        return float(v)
    except TypeError:  # e.g. 0-d ndarray wrapped oddly
        import numpy as np

        return float(np.asarray(v))


class AverageMeter:
    """Weighted running average: ``update(value, n)``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0
        self.avg = 0.0

    def update(self, val, n: float = 1) -> None:
        val = _to_float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)

    def compute(self) -> float:
        return self.avg


# the reference treats MeanMetric as a synonym-with-different-API; keep both
class MeanMetric(AverageMeter):
    def __call__(self, val, n: float = 1) -> None:
        self.update(val, n)


class MeterBank:
    """A lazily-created dict of AverageMeters keyed by metric name."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    def update(self, metrics: Dict[str, float], n: float = 1) -> None:
        for k, v in metrics.items():
            if k not in self.meters:
                self.meters[k] = AverageMeter()
            self.meters[k].update(v, n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self) -> None:
        for m in self.meters.values():
            m.reset()
