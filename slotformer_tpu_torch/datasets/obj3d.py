"""OBJ3D videos and slots, the port of ``slotformer_tpu/datasets/obj3d.py``.

A video is a folder of PNG frames ``test_{i}.png``, 1-indexed, under
``<data_root>/<split>/``. A training clip starts at every valid frame; val
and test take one clip a video, from its first frame. Val/test items carry
zero ``bbox``/``pres_mask`` stubs, so the metric API sees the keys it reads
(OBJ3D has no box annotations). The slots variant joins the slots file's
``{folder name: [T, N, C]}`` dict of its split.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from ..runtime.datamodule import Dataset
from ..runtime.io import glob_all, load_obj, read_img
from .utils import BaseTransforms


class Obj3DDataset(Dataset):
    """Clips (``img`` [T, H, W, 3]) or, with ``load_video``, whole videos
    (``get_video``: ``(video_len + 1) // frame_offset`` frames)."""

    def __init__(self, data_root: str, split: str,
                 obj3d_transform: BaseTransforms, n_sample_frames: int = 6,
                 frame_offset: Optional[int] = None, video_len: int = 50):
        if split not in ("train", "val", "test"):
            raise ValueError(f"OBJ3D has splits train/val/test, not {split!r}")
        self.data_root = osp.join(data_root, split)
        self.split = split
        self.obj3d_transform = obj3d_transform
        self.n_sample_frames = n_sample_frames
        self.frame_offset = frame_offset or 1
        self.video_len = video_len
        self.valid_idx = self._get_sample_idx()
        self.load_video = False

    def _get_sample_idx(self):
        self.files = [s.rstrip("/") for s in glob_all(self.data_root, only_dir=True)]
        self.num_videos = len(self.files)
        valid_idx = []
        for folder in self.files:
            if self.split == "train":
                max_start = (self.video_len
                             - (self.n_sample_frames - 1) * self.frame_offset)
                valid_idx += [(folder, i) for i in range(max_start)]
            else:
                valid_idx += [(folder, 0)]
        return valid_idx

    def _frames(self, folder: str, first: int, n: int) -> np.ndarray:
        """``n`` frames ``frame_offset`` apart from 0-based frame ``first``."""
        frames = [read_img(osp.join(folder, f"test_{first + 1 + i * self.frame_offset}.png"))
                  for i in range(n)]
        return np.stack([self.obj3d_transform(f) for f in frames]).astype(np.float32)

    def _read_frames(self, idx) -> np.ndarray:
        folder, start = self.valid_idx[idx]
        return self._frames(folder, start, self.n_sample_frames)

    def _read_bboxes(self, idx):
        """Zero box and presence stubs for the metric API."""
        return (np.zeros((self.n_sample_frames, 5, 4), np.float32),
                np.zeros((self.n_sample_frames, 5), bool))

    def get_video(self, video_idx: int) -> dict:
        num_frames = (self.video_len + 1) // self.frame_offset
        return {"video": self._frames(self.files[video_idx], 0, num_frames),
                "data_idx": video_idx}

    def __getitem__(self, idx):
        if self.load_video:
            return self.get_video(idx)
        out = {"data_idx": idx, "img": self._read_frames(idx)}
        if self.split != "train":
            out["bbox"], out["pres_mask"] = self._read_bboxes(idx)
        return out

    def __len__(self):
        return len(self.files) if self.load_video else len(self.valid_idx)


class Obj3DSlotsDataset(Obj3DDataset):
    """Clips with their slots (``slots`` [T, N, C]) read from ``video_slots``,
    keyed by the video folder's name."""

    def __init__(self, data_root: str, video_slots: dict, split: str,
                 obj3d_transform: BaseTransforms, n_sample_frames: int = 16,
                 frame_offset: Optional[int] = None, video_len: int = 50):
        super().__init__(data_root=data_root, split=split,
                         obj3d_transform=obj3d_transform,
                         n_sample_frames=n_sample_frames,
                         frame_offset=frame_offset, video_len=video_len)
        self.video_slots = video_slots

    def _read_slots(self, idx) -> np.ndarray:
        folder, start = self.valid_idx[idx]
        slots = self.video_slots[os.path.basename(folder)]  # [T, N, C]
        return np.stack([slots[start + n * self.frame_offset]
                         for n in range(self.n_sample_frames)]).astype(np.float32)

    def __getitem__(self, idx):
        out = {"data_idx": idx, "slots": self._read_slots(idx),
               "img": self._read_frames(idx)}
        if self.split != "train":
            out["bbox"], out["pres_mask"] = self._read_bboxes(idx)
        return out


def _args(params) -> dict:
    return dict(data_root=params.data_root, split="val",
                obj3d_transform=BaseTransforms(params.resolution),
                n_sample_frames=params.n_sample_frames,
                frame_offset=params.frame_offset, video_len=params.video_len)


def build_obj3d_dataset(params, val_only=False):
    args = _args(params)
    val_dataset = Obj3DDataset(**args)
    if val_only:
        return val_dataset
    return Obj3DDataset(**dict(args, split="train")), val_dataset


def build_obj3d_slots_dataset(params, val_only=False):
    slots = load_obj(params.slots_root)
    args = _args(params)
    val_dataset = Obj3DSlotsDataset(video_slots=slots["val"], **args)
    if val_only:
        return val_dataset
    train = Obj3DSlotsDataset(video_slots=slots["train"], **dict(args, split="train"))
    return train, val_dataset
