"""CLEVRER videos: the port of ``slotformer_tpu/datasets/clevrer.py``
(training clips and whole videos).

File lists are the reference's (train 0-10k, val 10k-15k, test 15k-20k,
broken video 10800 skipped; only videos present on disk, as an mp4 or a
directory of pre-extracted ``%06d.jpg`` frames, are kept). A training clip is
``n_sample_frames`` frames ``frame_offset`` apart from any start; val/test
clips cover each frame once. Frames are decoded with OpenCV (mp4) or PIL
(frame directories), both imported when a frame is read, resized to
``resolution`` and scaled to [-1, 1] NHWC float32. A clip that cannot be
read is replaced by a random other clip and flagged (``error_flag``), as in
the JAX package; a whole video of the wrong length raises.
``filter_enter`` and masks are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.datamodule import Dataset
from .utils import BaseTransforms, compact

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


def _read_video_frames(path: str, idxs):
    """The frames ``idxs`` of a video as RGB uint8 arrays (None where a
    frame cannot be read)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise ValueError(f"cannot open video: {path}")
    frames = []
    try:
        for i in idxs:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            ok, frame = cap.read()
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB) if ok else None)
    finally:
        cap.release()
    return frames


def _read_img(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class CLEVRERDataset(Dataset):
    """Clips (``img`` [T, H, W, 3]) of one split or, with ``load_video``,
    whole videos (``get_video``)."""

    def __init__(self, data_root: str, resolution, split: str = "train",
                 video_len: int = 128, n_sample_frames: int = 6,
                 frame_offset: int = 1):
        if split not in _SPLITS:
            raise ValueError(f"split {split!r}")
        self.split = split
        self.transforms = BaseTransforms(resolution)
        self.video_len = video_len
        self.n_sample_frames = n_sample_frames
        self.frame_offset = frame_offset
        video_path = os.path.join(data_root, "videos", split)
        start, end = _SPLITS[split]
        files = []
        for i in range(start, end):
            if i == 10800:  # annotation for this video is broken
                continue
            level = i // 1000
            d = f"video_{level * 1000:05d}-{(level + 1) * 1000:05d}"
            p = os.path.join(video_path, d, f"video_{i:05d}.mp4")
            if os.path.isfile(p) or os.path.isdir(os.path.splitext(p)[0]):
                files.append(p)
        self.files = sorted(compact(files))
        self.valid_idx = self._get_sample_idx()
        self.load_video = False

    def _get_sample_idx(self):
        """(video_idx, start_frame) pairs; val/test cover each frame once."""
        valid_idx = []
        max_start = self.video_len - (self.n_sample_frames - 1) * self.frame_offset
        size = self.n_sample_frames * self.frame_offset
        for video_idx in range(len(self.files)):
            if self.split == "train":
                valid_idx += [(video_idx, i) for i in range(max_start)]
            else:
                for base in range(0, self.video_len - size + 1, size):
                    valid_idx += [(video_idx, base + i)
                                  for i in range(self.frame_offset)]
        return valid_idx

    def _read_frames(self, idx) -> np.ndarray:
        video_idx, start = self.valid_idx[idx]
        path = self.files[video_idx]
        frame_dir = os.path.splitext(path)[0]
        idxs = [start + n * self.frame_offset for n in range(self.n_sample_frames)]
        if not os.path.isdir(frame_dir):
            frames = _read_video_frames(path, idxs)
        else:
            if len(os.listdir(frame_dir)) != self.video_len:
                raise ValueError("wrong video length")
            frames = [_read_img(os.path.join(frame_dir, f"{i:06d}.jpg"))
                      for i in idxs]
        if any(f is None for f in frames):
            raise ValueError("corrupted video")
        return np.stack([self.transforms(f) for f in frames]).astype(np.float32)

    def get_video(self, video_idx: int) -> dict:
        frames = _read_video(self.files[video_idx])
        if len(frames) != self.video_len:
            raise ValueError(f"{self.files[video_idx]}: {len(frames)} frames, "
                             f"expected {self.video_len}")
        video = [self.transforms(f) for f in frames[::self.frame_offset]]
        return {"video": np.stack(video).astype(np.float32),
                "error_flag": False, "data_idx": video_idx}

    def __getitem__(self, idx):
        if self.load_video:
            return self.get_video(idx)
        try:
            return {"data_idx": idx, "img": self._read_frames(idx),
                    "error_flag": False}
        except ValueError:
            out = self[int(np.random.choice(len(self)))]
            out["error_flag"] = True
            return out

    def __len__(self):
        if self.load_video:
            return len(self.files)
        return len(self.valid_idx)


def build_clevrer_dataset(params, val_only=False, test_set=False):
    if params.get("filter_enter", False) or params.get("load_mask", False):
        raise NotImplementedError("filter_enter and masks are not ported yet")
    # extraction configs, which read whole videos only, may omit the clip length
    args = dict(data_root=params.data_root, resolution=params.resolution,
                n_sample_frames=params.get("n_sample_frames", 6),
                frame_offset=params.frame_offset)
    if test_set:
        return CLEVRERDataset(split="test", **args)
    val_dataset = CLEVRERDataset(split="val", **args)
    if val_only:
        return val_dataset
    return CLEVRERDataset(split="train", **args), val_dataset
