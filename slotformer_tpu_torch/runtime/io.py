"""Host-side IO: the part of ``slotformer_tpu/runtime/io.py`` the port uses.

The slot artifact is the reference's pickle ``{split: {video_fn: float32
[T, N, C]}}``. Images and videos are read with PIL and OpenCV, both imported
when a file is read.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np


def mkdir_or_exist(dirname: str) -> None:
    if dirname:
        os.makedirs(dirname, exist_ok=True)


def strip_suffix(path: str) -> str:
    """Remove the file extension from a path."""
    return os.path.splitext(path)[0]


def load_obj(path: str) -> Any:
    """Load a json (by suffix) or else a pickle this program (or the JAX
    package) wrote."""
    if os.path.splitext(path)[1].lower() == ".json":
        with open(path, "r") as f:
            return json.load(f)
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_obj(obj: Any, path: str) -> None:
    """Save an object as a pickle, creating the parent directory."""
    mkdir_or_exist(os.path.dirname(path))
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def atomic_write_npy(arr: np.ndarray, path: str) -> None:
    """Write a ``.npy`` through a temporary file and a rename, so a killed
    job never leaves a truncated file for a restart to skip."""
    mkdir_or_exist(os.path.dirname(path))
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def symlink_force(target: str, link: str) -> None:
    """Point ``link`` at ``target``, replacing whatever is there.

    No-op when link == target; OS errors are ignored, since artifact
    symlinks are a convenience and nothing reads through them.
    """
    target = os.path.abspath(target)
    link = os.path.abspath(link)
    if link == target:
        return
    try:
        if os.path.islink(link) or os.path.exists(link):
            os.remove(link)
        os.symlink(target, link)
    except OSError:
        pass


# ---------------------------------------------------------------------------
# image / video IO
# ---------------------------------------------------------------------------

def read_img(path: str, to_float: bool = False) -> np.ndarray:
    """Read an image as RGB uint8 [H, W, 3] (float32 [0, 1] if to_float)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    if to_float:
        arr = arr.astype(np.float32) / 255.0
    return arr


def read_video(path: str) -> List[np.ndarray]:
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


def read_video_frames(path: str,
                      idxs: Sequence[int]) -> List[Optional[np.ndarray]]:
    """The frames ``idxs`` of a video as RGB uint8 arrays (None where a
    frame cannot be read); a video that does not open raises ValueError."""
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


def save_video(frames: Iterable[np.ndarray], path: str, fps: int = 8) -> None:
    """Save an iterable of RGB [H, W, 3] frames (uint8, or float in [0, 1])
    to an mp4."""
    import cv2

    frames = list(frames)
    if not frames:
        return
    mkdir_or_exist(os.path.dirname(path))
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for fr in frames:
        if fr.dtype != np.uint8:
            fr = np.clip(fr * 255.0, 0, 255).astype(np.uint8)
        writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
    writer.release()
