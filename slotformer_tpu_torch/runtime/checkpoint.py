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
from typing import Any, Dict, Mapping, Optional, Sequence, Union

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


def graft(dst: Mapping[str, torch.Tensor], src: Mapping[str, torch.Tensor],
          prefixes: Union[Sequence[str], Mapping[str, str]],
          strict: bool = True) -> Dict[str, torch.Tensor]:
    """A copy of the flat state_dict ``dst`` whose keys under each prefix
    hold ``src``'s tensors: the port of ``slotformer_tpu.runtime.checkpoint
    .graft`` on the reference's key layout.

    ``prefixes`` are top-level names (``'decoder'`` takes ``decoder.*``), or
    a map from a name in ``dst`` to a name in ``src``; the name ``''`` in
    ``src`` is its root (a dVAE trainer's checkpoint *is* the dVAE:
    ``dvae.encoder.0.m.weight`` <- ``encoder.0.m.weight``). ``src`` is a
    state_dict or a checkpoint dict holding one under ``'state_dict'``. A key
    of a prefix that ``src`` lacks raises ``KeyError``; a shape that differs
    or, with ``strict``, a key under the prefix (anywhere, for ``''``) that
    only ``src`` has raises ``ValueError``. The inputs are not changed.
    """
    src = src.get("state_dict", src)
    if not isinstance(prefixes, Mapping):
        prefixes = {p: p for p in prefixes}
    out = dict(dst)
    for dst_prefix, src_prefix in prefixes.items():
        keys = [k for k in dst if k.startswith(dst_prefix + ".")]
        if not keys:
            raise KeyError(f"graft: no key under {dst_prefix!r} in the target")
        src_dot = src_prefix + "." if src_prefix else ""
        want = set()
        for k in keys:
            sk = src_dot + k[len(dst_prefix) + 1:]
            want.add(sk)
            if sk not in src:
                raise KeyError(f"graft {dst_prefix!r}: source lacks {sk!r}")
            if tuple(src[sk].shape) != tuple(dst[k].shape):
                raise ValueError(
                    f"graft {dst_prefix!r}: shape mismatch at {k}: "
                    f"{tuple(dst[k].shape)} vs {tuple(src[sk].shape)}")
            out[k] = src[sk].detach().clone()
        if strict:
            extra = sorted(k for k in src if k.startswith(src_dot)
                           and k not in want)
            if extra:
                raise ValueError(f"graft {dst_prefix!r}: the source has keys "
                                 f"the target lacks: {extra[:5]}")
    return out


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``model_<it>.pth`` of ``ckpt_dir`` with the largest ``it``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = {int(m.group(1)): f for f in os.listdir(ckpt_dir)
             if (m := _CKPT.match(f))}
    if not steps:
        return None
    return os.path.join(ckpt_dir, steps[max(steps)])
