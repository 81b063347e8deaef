"""Dataset transforms: the part of ``slotformer_tpu/datasets/utils.py`` the
ported datasets use (a copy). RLE and mask utilities come with masks.

Transforms emit NHWC float32 in [-1, 1] (the reference's ToTensor +
Normalize(0.5, 0.5) + Resize).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def compact(lst: List) -> List:
    return list(filter(None, lst))


class BaseTransforms:
    """uint8 RGB [H, W, 3] -> float32 [-1, 1] [H', W', 3] (NHWC)."""

    def __init__(self, resolution: Tuple[int, int], mean=0.5, std=0.5):
        self.resolution = tuple(resolution)
        self.mean = mean
        self.std = std

    def __call__(self, img: np.ndarray) -> np.ndarray:
        import cv2

        if img.shape[:2] != self.resolution:
            img = cv2.resize(
                img,
                (self.resolution[1], self.resolution[0]),
                interpolation=cv2.INTER_LINEAR,
            )
        img = img.astype(np.float32) / 255.0
        return (img - self.mean) / self.std
