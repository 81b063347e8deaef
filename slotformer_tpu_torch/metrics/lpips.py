"""LPIPS perceptual distance (VGG16 backbone): the port of
``slotformer_tpu/metrics/lpips.py``.

  * the architecture (VGG16 features + linear calibration heads, unit-
    normalised channel differences, spatial mean, layer sum) in plain
    PyTorch;
  * ``load_lpips(weights_path, device=...)`` builds the metric from an
    ``.npz``/pickle weight file in the JAX package's format, so one
    converted file serves both;
  * ``load_lpips(None, fallback="untrained")`` builds it from a seeded
    *untrained* VGG (He-init convs, uniform calibration heads), the same
    numpy numbers as the JAX package draws. Features of untrained networks
    still form a perceptual metric (Zhang et al. 2018, section 5), so this is
    a meaningful though not paper-comparable ``percept_dist``; callers must
    say so where ``fn.source == "untrained"``;
  * ``load_lpips(None)`` returns None (callers report percept_dist = 0).

Weight file format: a dict {name: array} with the VGG conv kernels as
``conv{i}_{j}/kernel`` [kh, kw, cin, cout] (HWIO; transposed to torch's OIHW
on load), biases ``conv{i}_{j}/bias`` and the LPIPS heads ``lin{k}/kernel``
[1, 1, c, 1].
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 conv layout: (block, convs, channels)
_VGG_CFG = [(1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]
# ImageNet normalisation in [-1, 1] space (lpips ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _vgg_features(w: dict, x: torch.Tensor):
    """x [B, 3, H, W], normalised -> the 5 feature maps (pre-pool relu)."""
    feats = []
    for blk, n_convs, _ in _VGG_CFG:
        for j in range(1, n_convs + 1):
            x = F.relu(F.conv2d(x, w[f"conv{blk}_{j}/kernel"],
                                w[f"conv{blk}_{j}/bias"], padding=1))
        feats.append(x)
        if blk != 5:
            x = F.max_pool2d(x, 2)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Over the channel axis of [B, C, H, W]."""
    return x / (x.square().sum(1, keepdim=True).sqrt() + eps)


def untrained_lpips_weights(seed: int = 0) -> dict:
    """Deterministic untrained LPIPS weights: He-init VGG convs + uniform
    (1/C) calibration heads, as numpy arrays keyed and laid out (HWIO) like
    the converted file; the same numbers as the JAX package's."""
    rng = np.random.RandomState(seed)
    w = {}
    cin = 3
    for blk, n_convs, cout in _VGG_CFG:
        for j in range(1, n_convs + 1):
            fan_in = 3 * 3 * cin
            w[f"conv{blk}_{j}/kernel"] = (
                rng.randn(3, 3, cin, cout) * np.sqrt(2.0 / fan_in)
            ).astype(np.float32)
            w[f"conv{blk}_{j}/bias"] = np.zeros((cout,), np.float32)
            cin = cout
    for i, (_, _, c) in enumerate(_VGG_CFG):
        w[f"lin{i}/kernel"] = np.full((1, 1, c, 1), 1.0 / c, np.float32)
    return w


def load_lpips(weights_path: Optional[str] = None,
               fallback: Optional[str] = None,
               device="cpu") -> Optional[Callable]:
    """``fn(x, y) -> [B]`` LPIPS distances with its weights on ``device``,
    or None without weights.

    x/y are NHWC in [-1, 1], tensors or numpy arrays. ``fn.source`` is
    ``"file"`` or ``"untrained"``, so callers can label the metric.
    ``fallback="untrained"`` uses ``untrained_lpips_weights`` when no weights
    file is found instead of returning None.
    """
    if not weights_path:
        weights_path = os.environ.get("LPIPS_WEIGHTS", "")
    if not weights_path or not os.path.isfile(weights_path):
        if fallback == "untrained":
            return _build_lpips_fn(untrained_lpips_weights(),
                                   source="untrained", device=device)
        if fallback is not None:
            raise ValueError(f"unknown LPIPS fallback: {fallback!r}")
        return None
    if weights_path.endswith(".npz"):
        w = dict(np.load(weights_path))
    else:
        with open(weights_path, "rb") as f:
            w = pickle.load(f)
    return _build_lpips_fn(w, source="file", device=device)


def _build_lpips_fn(w: dict, source: str, device="cpu") -> Callable:
    # HWIO -> OIHW for the conv kernels and the 1x1 heads alike
    w = {k: torch.as_tensor(np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4
                            else np.asarray(v)).contiguous().to(device)
         for k, v in w.items()}
    shift = torch.from_numpy(_SHIFT).to(device)[:, None, None]
    scale = torch.from_numpy(_SCALE).to(device)[:, None, None]

    @torch.no_grad()
    def lpips_fn(x, y):
        x, y = (torch.as_tensor(a, device=device).permute(0, 3, 1, 2)
                for a in (x, y))
        n = x.shape[0]
        # both images through the VGG in one batch
        feats = _vgg_features(w, (torch.cat([x, y]) - shift) / scale)
        total = 0.0
        for i, f in enumerate(feats):
            f = _unit_normalize(f)
            d = F.conv2d((f[:n] - f[n:]) ** 2, w[f"lin{i}/kernel"])
            total = total + d.mean(dim=(1, 2, 3))
        return total

    lpips_fn.source = source
    return lpips_fn
