"""Synthetic bouncing-shapes video dataset, the port of
``slotformer_tpu/datasets/synthetic.py``: the videos, and the videos joined
with precomputed slots.

Lets every stage of the pipeline run without downloading CLEVRER. Deterministic
given (split, index): colored squares/circles move with constant velocity and
bounce off walls, rendered on a dark background in [-1, 1] NHWC float32.
"""

from __future__ import annotations

import numpy as np
from torch.utils.data import Dataset

from ..runtime.io import load_obj
from .utils import masks_to_boxes_pad


def _render_video(seed, video_len, res, num_objects,
                  obj_size_range=(0.08, 0.16)):
    rng = np.random.default_rng(seed)
    n = rng.integers(2, num_objects + 1)
    pos = rng.uniform(0.15, 0.85, size=(n, 2))
    vel = rng.uniform(-0.03, 0.03, size=(n, 2))
    size = rng.uniform(*obj_size_range, size=(n,))
    color = rng.uniform(0.3, 1.0, size=(n, 3))
    shape = rng.integers(0, 2, size=(n,))

    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    video = np.zeros((video_len, res, res, 3), np.float32)
    masks = np.zeros((video_len, res, res), np.int64)
    for t in range(video_len):
        frame = np.zeros((res, res, 3), np.float32)
        seg = np.zeros((res, res), np.int64)
        for i in range(n):
            cy, cx = pos[i]
            if shape[i] == 0:
                m = (np.abs(yy - cy) < size[i] / 2) & (np.abs(xx - cx) < size[i] / 2)
            else:
                m = (yy - cy) ** 2 + (xx - cx) ** 2 < (size[i] / 2) ** 2
            frame[m] = color[i]
            seg[m] = i + 1
        video[t] = frame
        masks[t] = seg
        pos += vel
        bounce = (pos < 0.05) | (pos > 0.95)
        vel[bounce] *= -1
        pos = np.clip(pos, 0.05, 0.95)
    return video * 2.0 - 1.0, masks  # [-1, 1]


class SyntheticVideoDataset(Dataset):
    """Clips (``img`` [T, H, W, 3]) or, with ``load_video``, whole videos."""

    def __init__(
        self,
        split: str = "train",
        num_videos: int = 100,
        video_len: int = 20,
        resolution=(64, 64),
        n_sample_frames: int = 6,
        frame_offset: int = 1,
        num_objects: int = 4,
        load_mask: bool = False,
        obj_size_range=(0.08, 0.16),
    ):
        self.split = split
        self.num_videos = num_videos
        self.video_len = video_len
        self.resolution = tuple(resolution)
        self.n_sample_frames = n_sample_frames
        self.frame_offset = frame_offset
        self.num_objects = num_objects
        self.load_mask = load_mask
        self.obj_size_range = tuple(obj_size_range)
        self._seed_base = {"train": 0, "val": 10_000_000, "test": 20_000_000}[split]
        self._cache = {}
        # clip index: one clip per (video, start)
        max_start = video_len - (n_sample_frames - 1) * frame_offset
        if split == "train":
            self.valid_idx = [
                (v, s) for v in range(num_videos) for s in range(max_start)
            ]
        else:
            self.valid_idx = [(v, 0) for v in range(num_videos)]
        self.files = [f"synthetic_{split}_{i:05d}" for i in range(num_videos)]
        self.load_video = False

    def _video(self, video_idx):
        if video_idx not in self._cache:
            if len(self._cache) > 4096:  # ~5 GB of 64x64x20 videos
                self._cache.clear()
            self._cache[video_idx] = _render_video(
                self._seed_base + video_idx,
                self.video_len,
                self.resolution[0],
                self.num_objects,
                self.obj_size_range,
            )
        return self._cache[video_idx]

    def get_video(self, video_idx):
        video, _ = self._video(video_idx)
        return {
            "video": video[:: self.frame_offset].copy(),
            "data_idx": video_idx,
            "error_flag": False,
        }

    def __getitem__(self, idx):
        if self.load_video:
            return self.get_video(idx)
        video_idx, start = self.valid_idx[idx]
        video, masks = self._video(video_idx)
        sel = [start + n * self.frame_offset for n in range(self.n_sample_frames)]
        out = {"data_idx": idx, "img": video[sel].copy(), "error_flag": False}
        if self.load_mask:
            out["mask"] = masks[sel].copy()
        return out

    def __len__(self):
        if self.load_video:
            return self.num_videos
        return len(self.valid_idx)


class SyntheticSlotsDataset(Dataset):
    """Synthetic videos joined with precomputed slots ``{video_fn: [T, N,
    C]}``: ``slots`` [T, N, C], with ``load_img`` also ``img``, with
    ``load_mask`` also ``mask`` [T, H, W] (0 = background) and, from it,
    ``bbox`` [T, max_n_objects + 1, 4] and ``pres_mask``."""

    def __init__(self, video_dataset: SyntheticVideoDataset, video_slots: dict,
                 n_sample_frames: int = 16, load_img: bool = False,
                 load_mask: bool = False, max_n_objects: int = 4):
        self.base = video_dataset
        self.video_slots = video_slots
        self.n_sample_frames = n_sample_frames
        self.load_img = load_img
        self.load_mask = load_mask
        self.max_n_objects = max_n_objects
        max_start = self.base.video_len - (n_sample_frames - 1) * self.base.frame_offset
        if self.base.split == "train":
            self.valid_idx = [
                (v, s) for v in range(self.base.num_videos) for s in range(max_start)
            ]
        else:
            self.valid_idx = [(v, 0) for v in range(self.base.num_videos)]

    def __len__(self):
        return len(self.valid_idx)

    def __getitem__(self, idx):
        video_idx, start = self.valid_idx[idx]
        slots = self.video_slots[self.base.files[video_idx]]
        off = self.base.frame_offset
        sel = [start + n * off for n in range(self.n_sample_frames)]
        out = {
            "data_idx": idx,
            "slots": np.stack([slots[s] for s in sel]).astype(np.float32),
            "error_flag": False,
        }
        if self.load_img:
            video, _ = self.base._video(video_idx)
            out["img"] = video[sel].copy()
        if self.load_mask:
            _, masks = self.base._video(video_idx)
            m = masks[sel]
            out["mask"] = m.copy()
            boxes = [
                masks_to_boxes_pad(
                    np.stack([(fr == c).astype(np.uint8)
                              for c in range(1, self.max_n_objects + 1)]),
                    self.max_n_objects + 1,
                )
                for fr in m
            ]
            out["bbox"] = np.stack([b[0] for b in boxes]).astype(np.float32)
            out["pres_mask"] = np.stack([b[1] for b in boxes])
        return out


def build_synthetic_dataset(params, val_only=False):
    args = dict(
        split="val",
        num_videos=params.get("num_videos_val", 16),
        video_len=params.get("video_len", 20),
        resolution=params.resolution,
        n_sample_frames=params.n_sample_frames,
        frame_offset=params.frame_offset,
        load_mask=params.get("load_mask", False),
        num_objects=params.get("num_objects", 4),
        obj_size_range=params.get("obj_size_range", (0.08, 0.16)),
    )
    val_dataset = SyntheticVideoDataset(**args)
    if val_only:
        return val_dataset
    args["split"] = "train"
    args["num_videos"] = params.get("num_videos_train", 64)
    return SyntheticVideoDataset(**args), val_dataset


def build_synthetic_slots_dataset(params, val_only=False):
    slots = load_obj(params.slots_root)

    def base(split, num_videos):
        return SyntheticVideoDataset(
            split=split,
            num_videos=num_videos,
            video_len=params.get("video_len", 20),
            resolution=params.resolution,
            n_sample_frames=params.n_sample_frames,
            frame_offset=params.frame_offset,
            num_objects=params.get("num_objects", 4),
            obj_size_range=params.get("obj_size_range", (0.08, 0.16)),
        )

    val_dataset = SyntheticSlotsDataset(
        base("val", params.get("num_videos_val", 16)), slots["val"],
        params.n_sample_frames, params.get("load_img", False),
        params.get("load_mask", False), params.get("num_objects", 4),
    )
    if val_only:
        return val_dataset
    # the training split never loads masks, as in the JAX package
    train_dataset = SyntheticSlotsDataset(
        base("train", params.get("num_videos_train", 64)), slots["train"],
        params.n_sample_frames, params.get("load_img", False),
    )
    return train_dataset, val_dataset
