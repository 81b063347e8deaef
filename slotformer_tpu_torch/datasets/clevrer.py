"""CLEVRER videos: the port of ``slotformer_tpu/datasets/clevrer.py``
(training clips, whole videos, masks and boxes from the derender proposals,
``filter_enter``, and the clips joined with precomputed slots).

File lists are the reference's (train 0-10k, val 10k-15k, test 15k-20k,
broken video 10800 skipped; only videos present on disk, as an mp4 or a
directory of pre-extracted ``%06d.jpg`` frames, are kept). A training clip is
``n_sample_frames`` frames ``frame_offset`` apart from any start; val/test
clips cover each frame once. Frames are decoded with OpenCV (mp4) or PIL
(frame directories), both imported when a frame is read, resized to
``resolution`` and scaled to [-1, 1] NHWC float32. A clip that cannot be
read is replaced by a random other clip and flagged (``error_flag``), as in
the JAX package; a whole video of the wrong length raises.

``load_mask`` reads ``derender_proposals/proposal_<id>.json`` (COCO RLE
masks per frame) into ``mask`` [T, H, W] ids (0 = background), ``bbox``
[T, max_n_objects + 1, 4] and ``pres_mask``. ``filter_enter`` reads the
``annotations`` trajectories and drops the clips in which an object enters
the view after the burn-in frames.
"""

from __future__ import annotations

import os

import numpy as np

from ..runtime.datamodule import Dataset
from ..runtime.io import (load_obj, read_img, read_video, read_video_frames,
                          strip_suffix)
from .utils import BaseTransforms, anno2mask, compact, masks_to_boxes_pad

_SPLITS = {"train": (0, 10000), "val": (10000, 15000), "test": (15000, 20000)}


class CLEVRERDataset(Dataset):
    """Clips (``img`` [T, H, W, 3]) of one split or, with ``load_video``,
    whole videos (``get_video``)."""

    def __init__(self, data_root: str, resolution, split: str = "train",
                 video_len: int = 128, n_sample_frames: int = 6,
                 frame_offset: int = 1, max_n_objects: int = 6,
                 warmup_len: int = 5, load_mask: bool = False,
                 filter_enter: bool = False):
        if split not in _SPLITS:
            raise ValueError(f"split {split!r}")
        self.data_root = data_root
        self.split = split
        self.transforms = BaseTransforms(resolution)
        self.max_n_objects = max_n_objects
        self.video_len = video_len
        self.n_sample_frames = n_sample_frames
        self.warmup_len = warmup_len
        self.frame_offset = frame_offset
        self.load_mask = load_mask
        self.filter_enter = filter_enter
        video_path = os.path.join(data_root, "videos", split)
        start, end = _SPLITS[split]
        files = []
        for i in range(start, end):
            if i == 10800:  # annotation for this video is broken
                continue
            level = i // 1000
            d = f"video_{level * 1000:05d}-{(level + 1) * 1000:05d}"
            p = os.path.join(video_path, d, f"video_{i:05d}.mp4")
            if os.path.isfile(p) or os.path.isdir(strip_suffix(p)):
                files.append(p)
        self.files = sorted(compact(files))
        self.num_videos = len(self.files)
        self.valid_idx = (self._get_filtered_sample_idx() if filter_enter
                          else self._get_sample_idx())
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

    # -------------------------------------------------- filter_enter support
    def _get_enter_time(self, video_file):
        """The frames at which an object comes into the camera's view."""
        anno = load_obj(video_file.replace("video", "annotation").replace(
            ".mp4", ".json"))
        trajs = anno["motion_trajectory"]
        num_objs = len(trajs[0]["objects"])
        all_t = []
        for i in range(len(trajs) - 1):
            cur, nxt = trajs[i]["objects"], trajs[i + 1]["objects"]
            for j in range(num_objs):
                if (not cur[j]["inside_camera_view"]
                        and nxt[j]["inside_camera_view"]):
                    all_t.append(i + 1)
                    break
        return all_t

    def _has_obj_enter(self, enter_t, idx):
        MIN_FRAMES = 3
        t1 = idx + (self.warmup_len - 1 - MIN_FRAMES + 1) * self.frame_offset
        t2 = idx + (self.n_sample_frames - 1) * self.frame_offset
        return any(t1 < t <= t2 for t in enter_t)

    def _get_filtered_sample_idx(self):
        """The clip index without the clips where an object enters
        mid-prediction (reference clevrer.py:248-275); val/test take the
        first clean start of each half-clip interval."""
        valid_idx = []
        for video_idx, video_file in enumerate(self.files):
            enter_t = self._get_enter_time(video_file)
            if self.split == "train":
                max_start = (self.video_len
                             - (self.n_sample_frames - 1) * self.frame_offset)
                valid_idx += [(video_idx, idx) for idx in range(max_start)
                              if not self._has_obj_enter(enter_t, idx)]
            else:
                size = (self.n_sample_frames - 1) * self.frame_offset
                interval = size // 2
                for idx in range(0, self.video_len - size, interval):
                    max_idx = min(idx + interval, self.video_len - size)
                    for sub in range(idx, max_idx):
                        if not self._has_obj_enter(enter_t, sub):
                            valid_idx.append((video_idx, sub))
                            break
        return valid_idx

    # ---------------------------------------------------------------- reads
    def _rand_another(self):
        return self[int(np.random.choice(len(self)))]

    def _read_frames(self, idx) -> np.ndarray:
        video_idx, start = self.valid_idx[idx]
        path = self.files[video_idx]
        frame_dir = strip_suffix(path)
        idxs = [start + n * self.frame_offset for n in range(self.n_sample_frames)]
        if not os.path.isdir(frame_dir):
            frames = read_video_frames(path, idxs)
        else:
            if len(os.listdir(frame_dir)) != self.video_len:
                raise ValueError("wrong video length")
            frames = [read_img(os.path.join(frame_dir, f"{i:06d}.jpg"))
                      for i in idxs]
        if any(f is None for f in frames):
            raise ValueError("corrupted video")
        return np.stack([self.transforms(f) for f in frames]).astype(np.float32)

    def _read_masks(self, idx):
        """(seg [T, H, W] int64, pres_mask [T, max_n_objects + 1], bbox
        [T, max_n_objects + 1, 4]) of a clip, from its derender proposals."""
        video_idx, start = self.valid_idx[idx]
        video_fn = os.path.basename(strip_suffix(self.files[video_idx]))
        anno = load_obj(os.path.join(self.data_root, "derender_proposals",
                                     f"proposal_{video_fn[-5:]}.json"))
        masks = [anno2mask(anno["frames"][start + n * self.frame_offset])
                 for n in range(self.n_sample_frames)]
        masks = [self.transforms.process_mask(m) for m in masks]
        boxes = [masks_to_boxes_pad(m[1:], self.max_n_objects + 1) for m in masks]
        seg = np.stack([m.argmax(0) for m in masks]).astype(np.int64)
        pres_mask = np.stack([b[1] for b in boxes])
        bboxes = np.stack([b[0] for b in boxes]).astype(np.float32)
        return seg, pres_mask, bboxes

    def get_video(self, video_idx: int) -> dict:
        frames = read_video(self.files[video_idx])
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
            out = {"data_idx": idx, "img": self._read_frames(idx),
                   "error_flag": False}
            if self.load_mask:
                out["mask"], out["pres_mask"], out["bbox"] = self._read_masks(idx)
        except ValueError:
            out = self._rand_another()
            out["error_flag"] = True
        return out

    def __len__(self):
        if self.load_video:
            return len(self.files)
        return len(self.valid_idx)


class CLEVRERSlotsDataset(CLEVRERDataset):
    """CLEVRER clips joined with precomputed slots ``{video_fn: [T, N, C]}``
    (reference clevrer.py:278-363): ``slots`` [T, N, C], with ``load_img``
    also ``img``, with ``load_mask`` also the masks and boxes. A video
    without slots is replaced by a random other clip and flagged, like a
    corrupted one."""

    def __init__(self, data_root: str, video_slots: dict, resolution,
                 split: str = "train", video_len: int = 128,
                 n_sample_frames: int = 16, frame_offset: int = 1,
                 max_n_objects: int = 6, warmup_len: int = 5,
                 load_img: bool = False, load_mask: bool = False,
                 filter_enter: bool = True):
        self.load_img = load_img
        super().__init__(data_root, resolution, split=split,
                         video_len=video_len, n_sample_frames=n_sample_frames,
                         frame_offset=frame_offset, max_n_objects=max_n_objects,
                         warmup_len=warmup_len, load_mask=load_mask,
                         filter_enter=filter_enter)
        self.video_slots = video_slots

    def _read_slots(self, idx) -> np.ndarray:
        video_idx, start = self.valid_idx[idx]
        try:
            slots = self.video_slots[os.path.basename(self.files[video_idx])]
        except KeyError:
            raise ValueError("missing slots")
        return np.stack([slots[start + n * self.frame_offset]
                         for n in range(self.n_sample_frames)]).astype(np.float32)

    def __getitem__(self, idx):
        try:
            out = {"data_idx": idx, "slots": self._read_slots(idx),
                   "error_flag": False}
            if self.load_img:
                out["img"] = self._read_frames(idx)
            if self.load_mask:
                out["mask"], out["pres_mask"], out["bbox"] = self._read_masks(idx)
        except ValueError:
            out = self._rand_another()
            out["error_flag"] = True
        return out


def _clip_args(params) -> dict:
    # extraction configs, which read whole videos only, may omit the clip length
    n_sample_frames = params.get("n_sample_frames", 6)
    return dict(data_root=params.data_root, resolution=params.resolution,
                n_sample_frames=n_sample_frames,
                frame_offset=params.frame_offset, max_n_objects=6,
                warmup_len=params.get("input_frames", n_sample_frames),
                load_mask=params.get("load_mask", False),
                filter_enter=params.get("filter_enter", False))


def build_clevrer_dataset(params, val_only=False, test_set=False):
    args = _clip_args(params)
    if test_set:
        return CLEVRERDataset(split="test", **args)
    val_dataset = CLEVRERDataset(split="val", **args)
    if val_only:
        return val_dataset
    return CLEVRERDataset(split="train", **args), val_dataset


def build_clevrer_slots_dataset(params, val_only=False):
    slots = load_obj(params.slots_root)
    args = dict(_clip_args(params), load_img=params.get("load_img", False))
    val_dataset = CLEVRERSlotsDataset(video_slots=slots["val"], split="val",
                                      **args)
    if val_only:
        return val_dataset
    return (CLEVRERSlotsDataset(video_slots=slots["train"], split="train",
                                **args), val_dataset)
