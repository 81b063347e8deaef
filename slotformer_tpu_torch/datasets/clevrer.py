"""CLEVRER whole-video reading for slot extraction: the part of
``slotformer_tpu/datasets/clevrer.py`` that ``cli.extract_slots`` uses.

File lists are the reference's (train 0-10k, val 10k-15k, test 15k-20k,
broken video 10800 skipped; only videos present on disk are kept). A video
is decoded with OpenCV (imported when a video is read), subsampled by
``frame_offset``, resized to ``resolution`` and scaled to [-1, 1] NHWC
float32. A video of the wrong length raises (the JAX package substitutes a
random other video and flags it). Clip sampling, masks and ``filter_enter``
come with training.
"""

from __future__ import annotations

import os

import numpy as np
from torch.utils.data import Dataset

_SPLITS = {"train": (0, 10000), "val": (10000, 15000), "test": (15000, 20000)}


def _read_video(path: str):
    """All frames of a video as RGB uint8 [H, W, 3] arrays."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {path}")
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    return frames


def _to_input(img: np.ndarray, resolution) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> float32 [-1, 1] [H', W', 3] (bilinear resize)."""
    import cv2

    if img.shape[:2] != tuple(resolution):
        img = cv2.resize(img, (resolution[1], resolution[0]),
                         interpolation=cv2.INTER_LINEAR)
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


class CLEVRERDataset(Dataset):
    """Whole CLEVRER videos of one split (``get_video``)."""

    def __init__(self, data_root: str, resolution, split: str = "val",
                 video_len: int = 128, frame_offset: int = 1):
        if split not in _SPLITS:
            raise ValueError(f"split {split!r}")
        self.split = split
        self.resolution = tuple(resolution)
        self.video_len = video_len
        self.frame_offset = frame_offset
        video_path = os.path.join(data_root, "videos", split)
        start, end = _SPLITS[split]
        self.files = []
        for i in range(start, end):
            if i == 10800:  # annotation for this video is broken
                continue
            level = i // 1000
            d = f"video_{level * 1000:05d}-{(level + 1) * 1000:05d}"
            p = os.path.join(video_path, d, f"video_{i:05d}.mp4")
            if os.path.isfile(p):
                self.files.append(p)
        self.load_video = True

    def get_video(self, video_idx: int) -> dict:
        frames = _read_video(self.files[video_idx])
        if len(frames) != self.video_len:
            raise ValueError(f"{self.files[video_idx]}: {len(frames)} frames, "
                             f"expected {self.video_len}")
        video = [_to_input(f, self.resolution)
                 for f in frames[::self.frame_offset]]
        return {"video": np.stack(video).astype(np.float32),
                "error_flag": False, "data_idx": video_idx}

    def __getitem__(self, idx):
        return self.get_video(idx)

    def __len__(self):
        return len(self.files)


def build_clevrer_dataset(params, val_only=False, test_set=False):
    args = dict(data_root=params.data_root, resolution=params.resolution,
                frame_offset=params.frame_offset)
    if test_set:
        return CLEVRERDataset(split="test", **args)
    val_dataset = CLEVRERDataset(split="val", **args)
    if val_only:
        return val_dataset
    return CLEVRERDataset(split="train", **args), val_dataset
