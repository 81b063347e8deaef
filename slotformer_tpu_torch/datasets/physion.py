"""Physion videos, slots and labels, the port of
``slotformer_tpu/datasets/physion.py``: ``PhysionDataset``,
``PhysionSlotsDataset``, ``PhysionSlotsLabelDataset`` (whole-video slots and
the VQA label, for the readout head) and their builders.

Eight scenarios x {training, readout, test} subsets, listed by the split
files in ``_SPLIT_DIR`` (the port's own copy, ``splits/Physion/*.json``:
``{task: [relative mp4 path, ...]}``). A video is a folder of pre-extracted
``%06d.jpg`` frames at the mp4's path without its suffix. Precomputed dVAE
tokens (``[T, h*w]`` int ``.npy``) are read from the path with
``TrainMP4s/`` -> ``TrainNpys-$dvae/`` (and ``TestMP4s/`` ->
``TestNpys-$dvae/``) rewritten, where ``$dvae`` is the dVAE run's name
(``_dvae_path_from``); ``cli/tokenize_images.py`` writes them there.

A training clip is ``n_sample_frames`` frames ``frame_offset`` apart from
any start; val/test clips cover each frame once. Frames are read with PIL,
resized to ``resolution`` and scaled to [-1, 1] NHWC float32.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import List, Optional

import numpy as np

from ..runtime.datamodule import Dataset
from ..runtime.io import load_obj, read_all_lines, read_img
from .utils import BaseTransforms

# module-level so that tests can point it at mini split files
_SPLIT_DIR = osp.join(osp.dirname(osp.realpath(__file__)), "splits", "Physion")


def token_path(folder: str, dvae_path: str) -> str:
    """The ``.npy`` token file of a video folder: ``TrainMP4s/`` ->
    ``TrainNpys-<dvae_path>/``, ``TestMP4s/`` -> ``TestNpys-<dvae_path>/``."""
    return (folder.replace("TrainMP4s/", f"TrainNpys-{dvae_path}/")
            .replace("TestMP4s/", f"TestNpys-{dvae_path}/") + ".npy")


class PhysionDataset(Dataset):
    """Clips (``img`` [T, H, W, 3], ``token_id`` [T, h*w] when the token
    file exists) of one subset's split or, with ``load_video``, whole
    videos (``get_video``)."""

    def __init__(self, data_root: str, split: str, tasks: List[str],
                 physion_transform: BaseTransforms, n_sample_frames: int = 6,
                 frame_offset: Optional[int] = None, video_len: int = 150,
                 subset: str = "training"):
        if subset in ("training", "readout"):
            if split not in ("train", "val"):
                raise ValueError(f"subset {subset} has splits train/val, "
                                 f"not {split!r}")
        elif subset == "test":
            if split != "test":
                raise ValueError(f"subset test has split test, not {split!r}")
        else:
            raise NotImplementedError(f"Unknown subset: {subset}")
        self.data_root = data_root
        self.split = split
        self.tasks = list(tasks)
        self.physion_transform = physion_transform
        self.n_sample_frames = n_sample_frames
        self.frame_offset = frame_offset or 1
        self.video_len = video_len
        self.subset = subset
        self.dvae_path = "dvae-none"  # set by the builders for token loading
        self.valid_idx = self._get_sample_idx()
        self.load_video = False

    def _get_sample_idx(self):
        json_file = load_obj(osp.join(_SPLIT_DIR, f"{self.subset}_{self.split}.json"))
        self.all_tasks = sorted(json_file.keys())
        self.video_idx2task_idx = {}
        self.files = []
        if self.tasks[0].lower() == "all":
            self.tasks = list(json_file.keys())
        for task in self.tasks:
            i1 = len(self.files)
            self.files.extend(osp.join(self.data_root, f[:-4])
                              for f in json_file[task])
            self.video_idx2task_idx.update(
                {i: self.all_tasks.index(task) for i in range(i1, len(self.files))})
        self.num_videos = len(self.files)
        valid_idx = []
        for folder in self.files:
            if self.split == "train":
                max_start = (self.video_len
                             - (self.n_sample_frames - 1) * self.frame_offset)
                valid_idx += [(folder, i) for i in range(max_start)]
            else:
                size = self.n_sample_frames * self.frame_offset
                for base in range(0, self.video_len - size + 1, size):
                    valid_idx += [(folder, base + i)
                                  for i in range(self.frame_offset)]
        return valid_idx

    def _rand_another(self):
        return self[int(np.random.choice(len(self)))]

    def _frames(self, folder: str, idxs) -> np.ndarray:
        if not osp.exists(folder):
            raise FileNotFoundError(f"{folder}: extract the frames of the "
                                    "videos first")
        frames = [read_img(osp.join(folder, f"{i:06d}.jpg")) for i in idxs]
        return np.stack([self.physion_transform(f) for f in frames]).astype(np.float32)

    def _clip_idxs(self, start: int):
        return [start + n * self.frame_offset for n in range(self.n_sample_frames)]

    def _read_frames(self, idx) -> np.ndarray:
        folder, start = self.valid_idx[idx]
        return self._frames(folder, self._clip_idxs(start))

    def _read_tokens(self, idx) -> Optional[np.ndarray]:
        folder, start = self.valid_idx[idx]
        npy_file = token_path(folder, self.dvae_path)
        if not osp.exists(npy_file):
            return None
        tokens = np.load(npy_file)  # [T, h*w]
        return tokens[self._clip_idxs(start)].astype(np.int32)

    def get_video(self, video_idx: int) -> dict:
        idxs = range(0, self.video_len // self.frame_offset * self.frame_offset,
                     self.frame_offset)
        return {"video": self._frames(self.files[video_idx], idxs),
                "data_idx": video_idx}

    def __getitem__(self, idx):
        if self.load_video:
            return self.get_video(idx)
        out = {"data_idx": idx, "img": self._read_frames(idx)}
        tokens = self._read_tokens(idx)
        if tokens is not None:
            out["token_id"] = tokens
        return out

    def __len__(self):
        if self.load_video:
            return len(self.files)
        return len(self.valid_idx)


class PhysionSlotsDataset(PhysionDataset):
    """Clips of precomputed slots ``{video_basename: [T, N, C]}`` (``slots``
    [T, N, C]; with ``load_img`` also ``img`` and ``token_id``). A video
    without slots is replaced by a random other clip."""

    def __init__(self, data_root, video_slots, split, tasks, physion_transform,
                 n_sample_frames=25, frame_offset=None, video_len=150,
                 subset="training", load_img=False):
        super().__init__(data_root=data_root, split=split, tasks=tasks,
                         physion_transform=physion_transform,
                         n_sample_frames=n_sample_frames,
                         frame_offset=frame_offset, video_len=video_len,
                         subset=subset)
        self.video_slots = video_slots
        self.load_img = load_img

    def _read_slots(self, idx) -> np.ndarray:
        folder, start = self.valid_idx[idx]
        slots = self.video_slots[os.path.basename(folder)]
        return slots[self._clip_idxs(start)].astype(np.float32)

    def __getitem__(self, idx):
        try:
            out = {"slots": self._read_slots(idx)}
        except KeyError:
            return self._rand_another()
        if self.load_img:
            out["img"] = self._read_frames(idx)
            tokens = self._read_tokens(idx)
            if tokens is not None:
                out["token_id"] = tokens
        out["data_idx"] = idx
        return out


class PhysionSlotsLabelDataset(PhysionSlotsDataset):
    """(slots of the first ``video_len`` frames [video_len, N, C], the VQA
    label) of each video of the readout or test subset, with ``task_idx``,
    the video's task in ``all_tasks``. Labels come from
    ``PhysionTrainMP4s/readout_labels.csv`` or ``PhysionTestMP4s/labels.csv``
    under ``data_root``. The test subset drops the stimuli listed in
    ``bad_stimuli.txt`` and reads the label of a ``-redyellow`` video under
    its name without that suffix. An item that cannot be read is replaced
    by a random other one, drawn from the dataset's own generator."""

    def __init__(self, data_root, video_slots, split, tasks, physion_transform,
                 n_sample_frames=15, frame_offset=None, video_len=150,
                 subset="training", load_img=False):
        if subset == "readout":
            label_fn = "PhysionTrainMP4s/readout_labels.csv"
        elif subset == "test":
            label_fn = "PhysionTestMP4s/labels.csv"
        else:
            raise NotImplementedError(f"subset {subset!r} has no labels")
        self.labels = _read_label_csv(osp.join(data_root, label_fn))
        super().__init__(data_root=data_root, video_slots=video_slots,
                         split=split, tasks=tasks,
                         physion_transform=physion_transform,
                         n_sample_frames=n_sample_frames,
                         frame_offset=frame_offset, video_len=video_len,
                         subset=subset, load_img=load_img)
        if self.frame_offset != 1:
            raise ValueError("the label dataset reads every frame")
        self.sample_idx = list(range(video_len))
        self.rng = np.random.default_rng(0)
        if subset != "readout":
            bad = read_all_lines(osp.join(_SPLIT_DIR, "bad_stimuli.txt"))
            keep, keep_tasks = [], {}
            for i, f in enumerate(self.files):
                if not any(s in f.replace("-redyellow", "") for s in bad):
                    # the task map follows the kept files' new indices
                    keep_tasks[len(keep)] = self.video_idx2task_idx[i]
                    keep.append(f)
            print(f"remove {len(self.files) - len(keep)} files, now have "
                  f"{len(keep)}")
            self.files = keep
            self.video_idx2task_idx = keep_tasks

    def _rand_another(self):
        return self[int(self.rng.integers(len(self)))]

    def _read_frames(self, file_idx) -> np.ndarray:
        return self._frames(self.files[file_idx], self.sample_idx)

    def _read_slots(self, file_idx) -> np.ndarray:
        slots = self.video_slots[osp.basename(self.files[file_idx])]
        return slots[self.sample_idx].astype(np.float32)

    def _read_label(self, file_idx) -> int:
        key = osp.basename(self.files[file_idx])
        if key.endswith(".mp4"):
            key = key[:-4]
        if self.subset == "readout" and key.endswith("_img"):
            key = key[:-4]
        if self.subset == "test":
            key = key.replace("-redyellow", "")
        return 1 if self.labels[key] else 0

    def __getitem__(self, idx):
        try:
            out = {"slots": self._read_slots(idx), "label": self._read_label(idx)}
            if self.load_img:
                out["img"] = self._read_frames(idx)
        except (ValueError, KeyError):
            return self._rand_another()
        out["data_idx"] = idx
        out["task_idx"] = self.video_idx2task_idx[idx]
        return out

    def __len__(self):
        return len(self.files)


def _read_label_csv(path: str) -> dict:
    """A CSV with columns (name, 'ground truth outcome') -> {name: bool}."""
    import csv

    out = {}
    with open(path, "r") as f:
        reader = csv.DictReader(f)
        name_col = reader.fieldnames[0]
        for row in reader:
            out[row[name_col]] = (str(row["ground truth outcome"]).strip().lower()
                                  in ("true", "1", "yes"))
    return out


def _dvae_path_from(params) -> str:
    """The dVAE run's name: the directory of ``dvae_dict['dvae_ckp_path']``
    under its top folder (``pretrained/<name>/model.pth``), else
    ``'dvae-none'``."""
    dvae = "dvae-none"
    if params.has("dvae_dict"):
        p = params.dvae_dict["dvae_ckp_path"].split("/")
        dvae = p[1] if len(p) > 1 else dvae
    if "dvae" not in dvae:
        raise ValueError(f"the dVAE checkpoint's directory {dvae!r} must name "
                         "the dVAE run (contain 'dvae')")
    return dvae


def build_physion_dataset(params, val_only=False):
    """``params.dataset`` is ``physion_<subset>``; (train, val), or val alone
    (the test subset has only that)."""
    subset = params.dataset.split("_")[-1]
    args = dict(data_root=params.data_root, split="val", tasks=params.tasks,
                physion_transform=BaseTransforms(params.resolution),
                n_sample_frames=params.n_sample_frames,
                frame_offset=params.frame_offset, video_len=params.video_len,
                subset=subset)
    if subset == "test":
        args["split"] = "test"
        val_only = True
    val_dataset = PhysionDataset(**args)
    val_dataset.dvae_path = _dvae_path_from(params)
    if val_only:
        return val_dataset
    train_dataset = PhysionDataset(**dict(args, split="train"))
    train_dataset.dvae_path = val_dataset.dvae_path
    return train_dataset, val_dataset


def build_physion_slots_dataset(params, val_only=False):
    """``params.dataset`` is ``physion_slots_<subset>``; the slots come from
    ``params.slots_root`` (``{'train', 'val'}`` or ``{'test'}``)."""
    subset = params.dataset.split("_")[-1]
    slots = load_obj(params.slots_root)
    args = dict(data_root=params.data_root, split="val", tasks=params.tasks,
                physion_transform=BaseTransforms(params.resolution),
                n_sample_frames=params.n_sample_frames,
                frame_offset=params.frame_offset, video_len=params.video_len,
                subset=subset, load_img=params.loss_dict["use_img_recon_loss"])
    if subset == "test":
        args.update(split="test", video_slots=slots["test"])
        val_only = True
    else:
        args["video_slots"] = slots["val"]
    val_dataset = PhysionSlotsDataset(**args)
    val_dataset.dvae_path = _dvae_path_from(params)
    if val_only:
        return val_dataset
    train_dataset = PhysionSlotsDataset(
        **dict(args, split="train", video_slots=slots["train"]))
    train_dataset.dvae_path = val_dataset.dvae_path
    return train_dataset, val_dataset


def build_physion_slots_label_dataset(params, val_only=False):
    """``params.dataset`` is ``physion_slots_label_<subset>`` (readout or
    test); the slots come from ``params.slots_root``."""
    subset = params.dataset.split("_")[-1]
    slots = load_obj(params.slots_root)
    args = dict(data_root=params.data_root, split="val", tasks=params.tasks,
                physion_transform=BaseTransforms(params.resolution),
                n_sample_frames=params.n_sample_frames,
                frame_offset=params.frame_offset, video_len=params.video_len,
                subset=subset)
    if subset == "test":
        args.update(split="test", video_slots=slots["test"])
        val_only = True
    else:
        args["video_slots"] = slots["val"]
    val_dataset = PhysionSlotsLabelDataset(**args)
    if val_only:
        return val_dataset
    return (PhysionSlotsLabelDataset(**dict(args, split="train",
                                            video_slots=slots["train"])),
            val_dataset)
