"""Host-side IO: the part of ``slotformer_tpu/runtime/io.py`` the slot CLIs use.

The slot artifact is the reference's pickle ``{split: {video_fn: float32
[T, N, C]}}``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any


def load_obj(path: str) -> Any:
    """Load a pickle this program (or the JAX package) wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


def dump_obj(obj: Any, path: str) -> None:
    """Save an object as a pickle, creating the parent directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


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
