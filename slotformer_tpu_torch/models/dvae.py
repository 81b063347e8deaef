"""Discrete VAE image tokenizer (dVAE), the port of
``slotformer_tpu/models/dvae.py``.

The encoder maps [.., H, W, 3] NHWC images to ``vocab_size`` token logits at
H/4 x W/4 (a 4x4/stride-4 block, six 1x1 blocks, a 1x1 conv); the decoder
maps token probabilities back to pixels through 1x1/3x3 blocks and two
``pixel_shuffle(2)`` upsamples. Token logits live on the LAST axis
([.., h, w, vocab]), as in the JAX package; the convolutions run in NCHW
inside.

State-dict layout as the reference: ``encoder.{0..7}`` and
``decoder.{0..4, 6..9, 11}`` (the indices skip the two parameter-free
PixelShuffles), each ``Conv2dBlock`` holding its conv at ``.m`` and its
GroupNorm(1)'s affine ``weight``/``bias`` on the block itself. GroupNorm
runs with eps 1e-6, the flax default, to hold against the JAX package (the
reference's is torch's 1e-5).

Gumbel noise comes from the ``torch.Generator`` the caller passes, or from
``uniform`` (the draws themselves, so a test can feed the ones JAX made).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import rand

GN_EPS = 1e-6


def make_one_hot(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """One-hot of the argmax along ``dim``, in ``logits``' dtype."""
    idx = logits.argmax(dim, keepdim=True)
    return torch.zeros_like(logits).scatter_(dim, idx, 1.0)


def gumbel_softmax(logits: torch.Tensor, tau: float = 1.0, hard: bool = False,
                   dim: int = -1, generator: Optional[torch.Generator] = None,
                   uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-softmax, straight-through with ``hard``. ``u ~ U[tiny, 1)``
    from ``generator`` (or ``uniform`` when given), ``g = -log(-log(u) +
    tiny)``, then the softmax of ``(logits + g) / tau``."""
    tiny = torch.finfo(logits.dtype).tiny
    if uniform is None:
        uniform = rand(logits.shape, generator, logits.device, logits.dtype)
    u = uniform.to(logits.dtype).clamp_min(tiny)
    gumbels = -torch.log(-torch.log(u) + tiny)
    y_soft = torch.softmax((logits + gumbels) / tau, dim=dim)
    if hard:
        return make_one_hot(y_soft, dim) - y_soft.detach() + y_soft
    return y_soft


class Conv2dBlock(nn.Module):
    """Bias-free conv (``m``) + GroupNorm(1) (affine ``weight``/``bias``) +
    ReLU. 1x1 and 4x4/stride-4 convs take no padding, 3x3 convs padding 1
    (XLA's ``SAME`` at these shapes)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 1, stride: int = 1):
        super().__init__()
        padding = kernel_size // 2 if stride == 1 else 0
        self.m = nn.Conv2d(in_channels, out_channels, kernel_size, stride,
                           padding, bias=False)
        self.weight = nn.Parameter(torch.ones(out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(F.group_norm(self.m(x), 1, self.weight, self.bias,
                                   eps=GN_EPS))


class dVAE(nn.Module):  # noqa: N801 (the reference's name)

    def __init__(self, vocab_size: int = 4096, img_channels: int = 3):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder = nn.Sequential(
            Conv2dBlock(img_channels, 64, 4, 4),
            *[Conv2dBlock(64, 64) for _ in range(6)],
            nn.Conv2d(64, vocab_size, 1))
        self.decoder = nn.Sequential(
            Conv2dBlock(vocab_size, 64), Conv2dBlock(64, 64, 3),
            Conv2dBlock(64, 64), Conv2dBlock(64, 64), Conv2dBlock(64, 256),
            nn.PixelShuffle(2),
            Conv2dBlock(64, 64, 3), Conv2dBlock(64, 64), Conv2dBlock(64, 64),
            Conv2dBlock(64, 256),
            nn.PixelShuffle(2),
            nn.Conv2d(64, img_channels, 1))

    @staticmethod
    def _nchw(x: torch.Tensor) -> torch.Tensor:
        """[.., H, W, C] -> [B', C, H, W] over the flattened leading axes."""
        return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)

    def encode_logits(self, imgs: torch.Tensor) -> torch.Tensor:
        """[.., H, W, 3] -> [.., h, w, vocab] logits."""
        x = self.encoder(self._nchw(imgs)).permute(0, 2, 3, 1)
        return x.reshape(*imgs.shape[:-3], *x.shape[1:])

    def tokenize(self, imgs: torch.Tensor, one_hot: bool = True) -> torch.Tensor:
        """[.., H, W, 3] -> one-hot [.., h, w, vocab] or ids [.., h, w]."""
        logits = self.encode_logits(imgs)
        return make_one_hot(logits) if one_hot else logits.argmax(-1)

    def detokenize(self, z: torch.Tensor) -> torch.Tensor:
        """[.., h, w, vocab] token probabilities -> [.., H, W, 3]."""
        if z.shape[-1] != self.vocab_size:
            raise ValueError(f"z has {z.shape[-1]} tokens, the dVAE "
                             f"{self.vocab_size}")
        x = self.decoder(self._nchw(z)).permute(0, 2, 3, 1)
        return x.reshape(*z.shape[:-3], *x.shape[1:])

    def forward(self, batch: dict, tau: float = 1.0, hard: bool = False,
                testing: bool = False,
                generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None):
        """``testing``: the token ids of ``batch['img']``; else the
        reconstruction through gumbel-softmax tokens and the token
        log-probabilities ``z_logits``."""
        img = batch["img"]
        if testing:
            return self.tokenize(img, one_hot=False)
        z_logits = F.log_softmax(self.encode_logits(img), dim=-1)
        z = gumbel_softmax(z_logits, tau, hard, -1, generator, uniform)
        return {"recon": self.detokenize(z), "z_logits": z_logits}

    def calc_train_loss(self, batch: dict, out: dict) -> dict:
        return {"recon_loss": ((out["recon"] - batch["img"]) ** 2).mean()}

    def train_loss(self, batch: dict, tau: float = 1.0, hard: bool = False,
                   generator: Optional[torch.Generator] = None) -> dict:
        out = self(batch, tau=tau, hard=hard, generator=generator)
        return self.calc_train_loss(batch, out)

    def eval_loss(self, batch: dict,
                  generator: Optional[torch.Generator] = None) -> dict:
        out = self(batch, tau=0.1, hard=False, generator=generator)
        return self.calc_train_loss(batch, out)
