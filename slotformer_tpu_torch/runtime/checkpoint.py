"""Checkpoints in the reference's format: ``torch.save`` of a dict whose
``'state_dict'`` holds the model's weights in the reference torch key layout.

The trainer's files (``model_<it>.pth``) add ``'optimizer'`` (the torch
optimizer's state_dict), ``'it'``, ``'epoch'`` and ``'rng'`` (the training
noise generator's state). Every entry is made of tensors, numbers, strings
and containers, so ``torch.load(path, weights_only=True)`` reads it, as
``slotformer_tpu/cli/convert_reference_ckpt.py`` does.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import torch

_CKPT = re.compile(r"^model_(\d+)\.pth$")


def save_checkpoint(path: str, state_dict: Dict[str, torch.Tensor],
                    **extra: Any) -> None:
    """Atomically write ``{'state_dict': state_dict, **extra}`` to ``path``
    (a temporary file, then ``os.replace``)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"state_dict": state_dict, **extra}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's dict on the CPU; a bare state_dict (some reference
    files are one) comes back as ``{'state_dict': ...}``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" not in ckpt:
        ckpt = {"state_dict": ckpt}
    return ckpt


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``model_<it>.pth`` of ``ckpt_dir`` with the largest ``it``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = {int(m.group(1)): f for f in os.listdir(ckpt_dir)
             if (m := _CKPT.match(f))}
    if not steps:
        return None
    return os.path.join(ckpt_dir, steps[max(steps)])
