"""PHYRE action videos and slots, the port of ``slotformer_tpu/datasets/phyre.py``.

Each item simulates an action video on the fly with the ``phyre`` simulator
(a host-side package, imported only when a video is simulated): the WAD
palette to RGB (black background with ``reverse_color``), the static tail
trimmed, padded or cropped to a fixed length. The actions of a split are a
balanced sample of the phyre 100k cache, kept as ``.npy`` split files in
``_SPLIT_DIR`` (the port's own copy, ``splits/PHYRE/``, holds the fold-0
files the shipped configs name). A split whose files are absent is drawn
anew from the cache and written there, with the draws of
``np.random.seed(fold)`` as in the JAX package, so both write the same
files. No fold's train actions are committed: the train split is always
drawn this way.

``PHYRESlotsDataset`` reads per-action slot files ``{idx:06d}.npy``
(written by ``cli/extract_phyre_slots.py`` or ``cli/rollout_phyre_slots.py``).
An item that cannot be read is replaced by a random other one, drawn from the
dataset's own generator.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from ..runtime.datamodule import Dataset
from .utils import BaseTransforms

# module-level so that tests can point it at a temporary directory
_SPLIT_DIR = osp.join(osp.dirname(osp.realpath(__file__)), "splits", "PHYRE")


def _require_phyre():
    try:
        import phyre

        return phyre
    except ImportError as e:
        raise ImportError(
            "simulating PHYRE actions needs the `phyre` package "
            "(pip install phyre==0.2.2 on a compatible host)") from e


def _hex_to_ints(hex_string):
    h = hex_string.strip("#")
    return int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16)


WAD_COLORS = np.array(
    [
        [255, 255, 255],  # white
        _hex_to_ints("f34f46"),  # red
        _hex_to_ints("6bcebb"),  # green
        _hex_to_ints("1877f2"),  # blue
        _hex_to_ints("4b4aa4"),  # purple
        _hex_to_ints("b9cad2"),  # gray
        [0, 0, 0],  # black
        _hex_to_ints("fcdfe3"),  # light red
    ],
    dtype=np.uint8,
)

WAD_REVERSE_COLORS = WAD_COLORS.copy()
WAD_REVERSE_COLORS[0] = [0, 0, 0]
WAD_REVERSE_COLORS[6] = [255, 255, 255]


def observations_to_uint8_rgb(scene: np.ndarray, reverse: bool = False):
    """A simulator observation (colour indices) as RGB, flipped vertically
    (``np.take``: the palette lookup, about 3x faster than indexing)."""
    return np.take(WAD_REVERSE_COLORS if reverse else WAD_COLORS, scene,
                   axis=0)[::-1]


def get_last_moving_idx(images) -> int:
    """Index of the last frame in which objects still move."""
    idx = int(np.argmax([(images[i] == images[i + 1]).all()
                         for i in range(len(images) - 1)]))
    return len(images) - 1 if idx == 0 else idx


def fix_video_len(video: np.ndarray, n: int) -> np.ndarray:
    """Exactly ``n`` frames: the last frame repeated, or the tail cut."""
    if len(video) < n:
        video = np.concatenate([video] + [video[-1:]] * (n - len(video)))
    elif len(video) > n:
        video = video[:n]
    return video


def _fold_tasks(phyre, protocal: str, fold: int, split: str):
    """The tasks of a split (train: the fold's train and dev tasks; val: its
    test tasks) among the 25 ball templates, and the eval setup."""
    eval_setup = f"ball_{protocal}_template"
    train_tasks, dev_tasks, test_tasks = phyre.get_fold(eval_setup, fold)
    tasks = train_tasks + dev_tasks if split == "train" else test_tasks
    templates = [f"{i:05d}" for i in range(25)]
    return [t for t in tasks if t.split(":")[0] in templates], eval_setup


class PHYREDataset(Dataset):
    """Clips (``img`` [seq_size, H, W, 3], ``label``, ``vid_len``) of the
    split's actions or, with ``load_video``, whole videos of ``vid_len``
    frames (``get_video``; ``start_idx``/``end_idx`` select a range)."""

    def __init__(self, data_root: str, split: str,
                 phyre_transform: BaseTransforms, seq_size: int = 6,
                 frame_offset: int = 1, fps: int = 1, protocal: str = "within",
                 fold: int = 0, vid_len: int = 15, ratio: float = 1.0,
                 pos_ratio: float = 0.2, reverse_color: bool = False):
        if frame_offset != 1:
            raise ValueError("PHYRE strides with fps, not frame_offset")
        self.data_root = data_root
        self.split = split
        self.phyre_transform = phyre_transform
        self.resolution = phyre_transform.resolution
        self.seq_size = seq_size
        self.fps = fps
        self.frame_offset = frame_offset
        self.protocal = protocal
        self.fold = fold
        self.vid_len = vid_len
        self.ratio = ratio
        self.pos_ratio = pos_ratio
        self.reverse_color = reverse_color
        # numpy's generators are thread-safe for the loader's thread pool
        self.rng = np.random.default_rng(0)

        self._simulator = None  # built on the first simulation
        self._filter_actions()
        self.files = self.video_info  # one "file" per action
        self.load_video = False
        self.start_idx = None
        self.end_idx = None

    # --------------------------------------------------------------- actions
    def _split_path(self) -> str:
        return osp.join(_SPLIT_DIR, f"{self.protocal}-fold_{self.fold}-"
                        f"{self.split}-data_{self.ratio}-pos_{self.pos_ratio}.npy")

    def _filter_actions(self) -> None:
        """Load the split's actions [A, 4] (task index, action) and labels,
        or draw them from the phyre 100k cache and write them."""
        info_path = self._split_path()
        label_path = info_path.replace(".npy", "-label.npy")
        if osp.exists(info_path) and osp.exists(label_path):
            self.video_info = np.load(info_path)
            self.act_labels = np.load(label_path)
            return
        phyre = _require_phyre()
        tasks, _ = _fold_tasks(phyre, self.protocal, self.fold, self.split)
        data = phyre.get_default_100k_cache("ball").get_sample(tasks, None)
        actions, statuses = data["actions"], data["simulation_statuses"]
        base = 2000 if self.split == "train" else 500
        num_pos = int(self.ratio * base * self.pos_ratio)
        num_neg = int(self.ratio * base * (1 - self.pos_ratio))
        # np.random.seed(fold)'s stream, as the JAX package draws it
        rs = np.random.RandomState(self.fold)
        info, labels = [], []
        for t_id in range(len(tasks)):
            pos = actions[statuses[t_id] == 1].copy()
            neg = actions[statuses[t_id] == -1].copy()
            rs.shuffle(pos)
            rs.shuffle(neg)
            pos, neg = pos[:num_pos], neg[:num_neg]
            acts = np.concatenate([pos, neg])
            vi = np.zeros((len(acts), 4))
            vi[:, 0] = t_id
            vi[:, 1:] = acts
            info.append(vi)
            labels.append(np.concatenate([np.ones(len(pos)), np.zeros(len(neg))]))
        self.video_info = np.concatenate(info)
        self.act_labels = np.concatenate(labels).astype(np.int32)
        os.makedirs(osp.dirname(info_path), exist_ok=True)
        np.save(info_path, self.video_info)
        np.save(label_path, self.act_labels)

    @property
    def simulator(self):
        if self._simulator is None:
            phyre = _require_phyre()
            tasks, eval_setup = _fold_tasks(phyre, self.protocal, self.fold,
                                            self.split)
            self._simulator = phyre.initialize_simulator(
                tasks, phyre.eval_setup_to_action_tier(eval_setup))
        return self._simulator

    # ----------------------------------------------------------------- reads
    def _preproc_img(self, img) -> np.ndarray:
        return np.ascontiguousarray(
            observations_to_uint8_rgb(img, reverse=self.reverse_color))

    def _simulate(self, idx):
        task_id, acts = self.video_info[idx, 0], self.video_info[idx, 1:]
        return self.simulator.simulate_action(
            int(task_id), acts, stride=60 // self.fps, need_images=True,
            need_featurized_objects=False)

    def _frames_and_label(self, sim, idx, images) -> tuple:
        frames = [self.phyre_transform(self._preproc_img(im)) for im in images]
        label = int(sim.status == 1)
        if label != self.act_labels[idx]:
            raise RuntimeError(f"action {idx}: the simulated label {label} is "
                               f"not the split file's {self.act_labels[idx]}")
        return np.stack(frames, axis=0).astype(np.float32), label

    def get_video(self, idx, video_len: Optional[int] = None) -> dict:
        """The whole video of action ``idx``: ``vid_len`` frames, the last
        one repeated past the simulation's end."""
        video_len = self.vid_len if video_len is None else video_len
        sim = self._simulate(idx)
        images = np.asarray(sim.images[::self.frame_offset])
        vid_len = min(len(images), video_len)
        video, label = self._frames_and_label(
            sim, idx, fix_video_len(images, video_len))
        return {"video": video, "data_idx": idx, "label": label,
                "vid_len": vid_len}

    def _read_frames(self, idx, video_len: Optional[int] = None) -> dict:
        """``video_len`` (default ``seq_size``) frames up to the last moving
        one; a shorter video raises ValueError unless ``video_len`` is
        given, which pads it."""
        pad_img = video_len is not None
        video_len = self.seq_size if video_len is None else video_len
        sim = self._simulate(idx)
        images = np.asarray(sim.images[::self.frame_offset])
        vid_len = min(len(images), video_len)
        images = images[:get_last_moving_idx(images) + 1]
        if len(images) < video_len:
            if not pad_img:
                raise ValueError(f"action {idx} stops moving before "
                                 f"{video_len} frames")
            images = fix_video_len(images, video_len)
        img, label = self._frames_and_label(sim, idx, images[:video_len])
        return {"img": img, "label": label, "vid_len": vid_len}

    def _rand_another(self):
        return self[int(self.rng.integers(len(self)))]

    def __getitem__(self, idx):
        if self.load_video:
            if self.start_idx is not None:
                idx = self.start_idx + idx
            return self.get_video(idx)
        try:
            out = self._read_frames(idx)
        except ValueError:
            return self._rand_another()
        out["data_idx"] = idx
        return out

    def __len__(self):
        if self.load_video and self.start_idx is not None:
            return self.end_idx - self.start_idx
        return self.video_info.shape[0]


class PHYRESlotsDataset(PHYREDataset):
    """The split's actions joined with their slot files ``{idx:06d}.npy``
    under ``slot_root``: ``slots`` [seq_size, N, C], ``vid_len``, ``label``
    (and ``img`` with ``load_img``)."""

    def __init__(self, data_root, slot_root, split, phyre_transform,
                 seq_size=6, frame_offset=1, fps=1, protocal="within", fold=0,
                 vid_len=15, ratio=1.0, pos_ratio=0.2, reverse_color=False,
                 load_img=False):
        super().__init__(
            data_root=data_root, split=split, phyre_transform=phyre_transform,
            seq_size=seq_size, frame_offset=frame_offset, fps=fps,
            protocal=protocal, fold=fold, vid_len=vid_len, ratio=ratio,
            pos_ratio=pos_ratio, reverse_color=reverse_color)
        self.slot_root = slot_root
        self.load_img = load_img

    def _read_slots(self, idx) -> dict:
        slots = np.load(osp.join(self.slot_root, f"{idx:06d}.npy"))
        slots = np.ascontiguousarray(slots.astype(np.float32)[::self.frame_offset])
        vid_len = min(len(slots), self.seq_size)
        return {"slots": fix_video_len(slots, self.seq_size),
                "vid_len": vid_len, "label": int(self.act_labels[idx])}

    def __getitem__(self, idx):
        try:
            out = self._read_slots(idx)
            if self.load_img:
                img = self._read_frames(idx, video_len=self.seq_size)
                out["img"] = img["img"]
                out["vid_len"] = min(out["vid_len"], img["vid_len"])
        except (ValueError, FileNotFoundError):
            return self._rand_another()
        out["data_idx"] = idx
        return out


def _args(params, split: str) -> dict:
    return dict(
        data_root=params.data_root, split=split,
        phyre_transform=BaseTransforms(params.resolution),
        seq_size=params.n_sample_frames, frame_offset=params.frame_offset,
        fps=params.fps, protocal=params.phyre_protocal, fold=params.phyre_fold,
        vid_len=params.video_len, ratio=params.data_ratio,
        pos_ratio=params.pos_ratio, reverse_color=params.reverse_color)


def build_phyre_dataset(params, val_only=False):
    val_dataset = PHYREDataset(**_args(params, "val"))
    if val_only:
        return val_dataset
    return PHYREDataset(**_args(params, "train")), val_dataset


def _build_slots(params, slot_root: str, load_img: bool, val_only: bool):
    val_dataset = PHYRESlotsDataset(slot_root=slot_root.format("val"),
                                    load_img=load_img, **_args(params, "val"))
    if val_only:
        return val_dataset
    train_dataset = PHYRESlotsDataset(slot_root=slot_root.format("train"),
                                      load_img=load_img,
                                      **_args(params, "train"))
    return train_dataset, val_dataset


def build_phyre_slots_dataset(params, val_only=False):
    """SAVi's slots of each action (``params.slots_root``, a ``{}`` pattern
    of the split); the val split also renders the frames, for the image
    loss of evaluation."""
    out = _build_slots(params, params.slots_root,
                       params.loss_dict["use_img_recon_loss"], val_only)
    val_dataset = out if val_only else out[1]
    val_dataset.load_img = True
    return out


def build_phyre_rollout_slots_dataset(params, val_only=False):
    """The rolled-out slots of each action (``params.slot_root``)."""
    return _build_slots(params, params.slot_root, False, val_only)
