"""Dataset transforms: the part of ``slotformer_tpu/datasets/utils.py`` the
ported datasets use (a copy): transforms, COCO RLE decoding (the pycocotools
decode in numpy, with the C decoder of ``native.py`` when it builds) and
mask-to-box utilities.

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

    def process_mask(self, mask: np.ndarray) -> np.ndarray:
        """Nearest-resize an integer mask ([H, W] or [N, H, W])."""
        import cv2

        single = mask.ndim == 2
        if single:
            mask = mask[None]
        if mask.shape[1:] != self.resolution:
            mask = np.stack(
                [
                    cv2.resize(
                        m.astype(np.uint8),
                        (self.resolution[1], self.resolution[0]),
                        interpolation=cv2.INTER_NEAREST,
                    )
                    for m in mask
                ]
            )
        mask = mask.astype(np.int64)
        return mask[0] if single else mask


# ---------------------------------------------------------------------------
# COCO RLE decoding (pycocotools.mask.decode replacement)
# ---------------------------------------------------------------------------

def rle_decode(rle: dict) -> np.ndarray:
    """Decode a COCO RLE dict {'size': [h, w], 'counts': str|bytes|list}
    into a [h, w] uint8 mask. Column-major run order per COCO spec.

    Uses the native C decoder (``slotformer_tpu_torch/native.py``; the
    CLEVRER mask evaluation decodes some 300 masks a sample) when it is
    available, else the numpy loop below."""
    from ..native import rle_decode_native

    native = rle_decode_native(rle)
    if native is not None:
        return native
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (list, tuple)):
        cnts = list(counts)
    else:
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        cnts = []
        i = 0
        while i < len(counts):
            x = 0
            k = 0
            more = True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(cnts) > 2:
                x += cnts[-2]
            cnts.append(x)
    out = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in cnts:
        out[pos : pos + c] = val
        pos += c
        val = 1 - val
    return out.reshape(w, h).T  # counts run down columns


def anno2mask(frame_anno: dict) -> np.ndarray:
    """CLEVRER derender proposal frame -> [1+N, H, W] masks, bg first
    (reference utils.py:46-56)."""
    masks = [rle_decode(obj["mask"]) for obj in frame_anno["objects"]]
    masks = np.stack(masks, axis=0).astype(np.int32)
    bg = np.logical_not(np.any(masks, axis=0))[None]
    return np.concatenate([bg, masks], axis=0)


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """[N, H, W] binary masks -> [N, 4] (x1, y1, x2, y2) boxes."""
    n = masks.shape[0]
    boxes = np.zeros((n, 4), np.float32)
    for i, m in enumerate(masks):
        ys, xs = np.nonzero(m)
        if len(ys) == 0:
            continue
        boxes[i] = [xs.min(), ys.min(), xs.max(), ys.max()]
    return boxes


def masks_to_boxes_pad(masks: np.ndarray, num: int):
    """Boxes from nonempty masks, padded to ``num`` with a presence mask
    (reference utils.py:59-77)."""
    keep = masks.reshape(masks.shape[0], -1).sum(-1) > 0
    masks = masks[keep]
    boxes = masks_to_boxes(masks)
    pad_boxes = np.zeros((num, 4), np.float32)
    pad_boxes[: boxes.shape[0]] = boxes
    pres = np.zeros((num,), bool)
    pres[: boxes.shape[0]] = True
    return pad_boxes, pres
