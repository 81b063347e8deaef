"""Visualization helpers for the eval CLIs: a copy of
``slotformer_tpu/metrics/vis.py``.

The surface of the reference's video_prediction/vp_vis.py: stack GT/pred
videos with a colored border marking burn-in (green) and rollout (red), and
draw bboxes. numpy/cv2 on the host, NHWC in [-1, 1].
"""

from __future__ import annotations

import numpy as np

from .vp_metrics import PALETTE_np


def _to_uint8(video: np.ndarray) -> np.ndarray:
    return np.clip((video * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)


def draw_border(video: np.ndarray, color, width: int = 2) -> np.ndarray:
    """video [T, H, W, 3] uint8; draws a colored frame border in-place."""
    video = video.copy()
    video[:, :width] = color
    video[:, -width:] = color
    video[:, :, :width] = color
    video[:, :, -width:] = color
    return video


def make_video(gt: np.ndarray, pred: np.ndarray, history_len: int) -> np.ndarray:
    """Stack GT on top of pred; pred frames get green border during burn-in,
    red during rollout. Inputs [T, H, W, 3] in [-1, 1] -> uint8 [T, 2H, W, 3].
    """
    gt = _to_uint8(np.asarray(gt))
    pred = _to_uint8(np.asarray(pred))
    T = min(gt.shape[0], pred.shape[0])
    gt, pred = gt[:T], pred[:T]
    burnin = draw_border(pred[:history_len], (0, 255, 0))
    rollout = draw_border(pred[history_len:], (255, 0, 0))
    pred = np.concatenate([burnin, rollout], axis=0)
    return np.concatenate([gt, pred], axis=1)


def colorize_mask(mask: np.ndarray) -> np.ndarray:
    """[T, H, W] int ids -> [T, H, W, 3] uint8 palette colors."""
    pal = PALETTE_np
    return pal[np.asarray(mask) % len(pal)]


def batch_draw_bbox(video: np.ndarray, bboxes: np.ndarray,
                    pres_mask: np.ndarray | None = None) -> np.ndarray:
    """Draw per-frame bboxes. video [T, H, W, 3] in [-1, 1] (or uint8),
    bboxes [T, N, 4] xyxy (-1 = empty), pres_mask [T, N] optional."""
    import cv2

    video = np.asarray(video)
    if video.dtype != np.uint8:
        video = _to_uint8(video)
    video = video.copy()
    bboxes = np.asarray(bboxes)
    T, N = bboxes.shape[:2]
    for t in range(T):
        for n in range(N):
            if pres_mask is not None and not pres_mask[t, n]:
                continue
            x1, y1, x2, y2 = bboxes[t, n]
            if x1 < 0:
                continue
            color = tuple(int(c) for c in PALETTE_np[n % len(PALETTE_np)])
            cv2.rectangle(
                video[t], (int(x1), int(y1)), (int(x2), int(y2)), color, 1
            )
    return video.astype(np.float32) / 255.0 * 2.0 - 1.0
