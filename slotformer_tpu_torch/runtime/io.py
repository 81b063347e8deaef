"""Host-side IO: the part of ``slotformer_tpu/runtime/io.py`` the port uses.

The slot artifact is the reference's pickle ``{split: {video_fn: float32
[T, N, C]}}``. Images and videos are read with PIL and OpenCV, both imported
when a file is read.
"""

from __future__ import annotations

import glob
import json
import os
import pickle
from typing import Any, Iterable, List, Optional, Sequence

import numpy as np


def mkdir_or_exist(dirname: str) -> None:
    if dirname:
        os.makedirs(dirname, exist_ok=True)


def glob_all(pattern_or_dir: str, only_dir: bool = False) -> List[str]:
    """Sorted glob; pass a directory to list its entries."""
    if os.path.isdir(pattern_or_dir):
        pattern_or_dir = os.path.join(pattern_or_dir, "*")
    results = sorted(glob.glob(pattern_or_dir))
    if only_dir:
        results = [r for r in results if os.path.isdir(r)]
    return results


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
    """Save an object as json (by suffix) or else a pickle, creating the
    parent directory."""
    mkdir_or_exist(os.path.dirname(path))
    if os.path.splitext(path)[1].lower() == ".json":
        with open(path, "w") as f:
            json.dump(obj, f)
        return
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

def read_all_lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [ln.rstrip("\n") for ln in f]


def read_img(path: str, to_float: bool = False) -> np.ndarray:
    """Read an image as RGB uint8 [H, W, 3] (float32 [0, 1] if to_float)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    if to_float:
        arr = arr.astype(np.float32) / 255.0
    return arr


def save_img(arr: np.ndarray, path: str) -> None:
    """Save an RGB image (uint8, or float in [0, 1]), creating the parent
    directory; the format follows the suffix."""
    from PIL import Image

    mkdir_or_exist(os.path.dirname(path))
    if arr.dtype != np.uint8:
        arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


class VideoReader:
    """An open video (OpenCV), the reference ``nerv.utils.VideoReader``'s
    surface: ``len()``, ``get_frame(idx)``, ``read_video()``,
    ``cvt2frames(dir)``; frames RGB uint8 [H, W, 3]."""

    def __init__(self, path: str, to_rgb: bool = True):
        import cv2

        self._cv2 = cv2
        self.path = path
        self.to_rgb = to_rgb
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self.num_frames = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS))
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def __len__(self) -> int:
        return self.num_frames

    def _cvt(self, frame: np.ndarray) -> np.ndarray:
        if self.to_rgb:
            frame = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)
        return frame

    def get_frame(self, idx: int) -> Optional[np.ndarray]:
        self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, idx)
        ok, frame = self.cap.read()
        return self._cvt(frame) if ok else None

    def read_video(self) -> List[np.ndarray]:
        self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, 0)
        frames = []
        while True:
            ok, frame = self.cap.read()
            if not ok:
                return frames
            frames.append(self._cvt(frame))

    def cvt2frames(self, frame_dir: str, target_shape: Optional[tuple] = None,
                   filename_tmpl: str = "{:06d}.jpg") -> int:
        """Write every frame to ``frame_dir`` (resized to ``target_shape``
        by area averaging when given); returns the number of frames."""
        mkdir_or_exist(frame_dir)
        frames = self.read_video()
        for i, fr in enumerate(frames):
            if target_shape is not None:
                fr = self._cv2.resize(fr, target_shape,
                                      interpolation=self._cv2.INTER_AREA)
            save_img(fr, os.path.join(frame_dir, filename_tmpl.format(i)))
        return len(frames)

    def close(self) -> None:
        self.cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_video(path: str) -> List[np.ndarray]:
    """All frames of a video as RGB uint8 [H, W, 3] arrays."""
    with VideoReader(path) as reader:
        return reader.read_video()


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
