"""Building blocks of the references: plain ``torch`` operations only.

Numerics follow the published models as the reference checkpoints hold
them: LayerNorm eps 1e-6, 'same' padding of the 5x5 stride-1 convolutions,
transposed convolutions with ``padding=k//2, output_padding=stride-1``, a
ReLU FFN with dropout 0.1 in the transformer layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


def layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def coord_grid(h: int, w: int) -> torch.Tensor:
    """[1, H, W, 4] = (y, x, 1 - y, 1 - x) on [0, 1]."""
    ys = torch.linspace(0.0, 1.0, h, dtype=torch.float64).float()
    xs = torch.linspace(0.0, 1.0, w, dtype=torch.float64).float()
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([yy, xx], -1)
    return torch.cat([grid, 1.0 - grid], -1)[None]


class PositionEmbed(nn.Module):
    """Adds ``dense(grid)`` to an NCHW map (keys ``dense.*``, ``grid``)."""

    def __init__(self, channels: int, h: int, w: int):
        super().__init__()
        self.dense = nn.Linear(4, channels)
        self.register_buffer("grid", coord_grid(h, w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.dense(self.grid).permute(0, 3, 1, 2)


def sin_table(length: int, d_model: int) -> torch.Tensor:
    """[1, L, D] sinusoids at positions L-1 .. 0, sin half then cos half."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0.0, d_model, 2.0,
                                             dtype=torch.float64) / d_model))
    pos = torch.arange(length - 1, -1, -1, dtype=torch.float64)
    ang = pos[:, None] * inv_freq[None]
    return torch.cat([ang.sin(), ang.cos()], -1)[None].float()


def conv_stack(channels, ks: int, last_act: bool) -> nn.Sequential:
    """Conv2d(k, stride 1, pad k//2) [+ ReLU] per layer, keys ``<i>.0.*``."""
    layers = []
    for i in range(len(channels) - 1):
        parts = [nn.Conv2d(channels[i], channels[i + 1], ks, padding=ks // 2)]
        if last_act or i < len(channels) - 2:
            parts.append(nn.ReLU())
        layers.append(nn.Sequential(*parts))
    return nn.Sequential(*layers)


class BroadcastDecoder(nn.Module):
    """Spatial-broadcast decoder: slots [F, S, D] broadcast to the start
    grid, transposed convolutions (stride 2 until the frame size), a 1x1
    head to rgb + mask logit, masks softmaxed over the slots. Keys
    ``decoder.<i>.0.*``, ``decoder.<n>.*`` (the head) and
    ``decoder_pos_embedding.*`` on the parent that adopts it."""

    def __init__(self, slot_size: int, channels, start: int, ks: int,
                 resolution: int):
        super().__init__()
        layers, size = [], start
        for i in range(len(channels) - 1):
            stride = 1 if size == resolution else 2
            layers.append(nn.Sequential(
                nn.ConvTranspose2d(channels[i], channels[i + 1], ks, stride,
                                   padding=ks // 2,
                                   output_padding=stride - 1),
                nn.ReLU()))
            size *= stride
        if size != resolution:
            raise ValueError(f"decoder reaches {size}, not {resolution}")
        layers.append(nn.Conv2d(channels[-1], 4, 1))
        self.decoder = nn.Sequential(*layers)
        self.decoder_pos_embedding = PositionEmbed(slot_size, start, start)
        self.start = start

    def forward(self, slots: torch.Tensor):
        """[F, S, D] -> (recon [F, H, W, 3], masks [F, S, H, W, 1])."""
        f, s, d = slots.shape
        x = slots.reshape(f * s, d, 1, 1).expand(f * s, d, self.start,
                                                  self.start)
        x = self.decoder(self.decoder_pos_embedding(x))
        x = x.permute(0, 2, 3, 1).reshape(f, s, x.shape[2], x.shape[3], 4)
        masks = torch.softmax(x[..., 3:], dim=1)
        recon = (x[..., :3] * masks).sum(1)
        return recon, masks


class EncoderLayer(nn.Module):
    """Pre-LN transformer layer: x + Drop(MHA(LN(x))), then x +
    Drop(W2 Drop(ReLU(W1 LN(x)))); keys as ``nn.TransformerEncoderLayer``.

    In training the attention is ``nn.MultiheadAttention`` itself, so that
    its dropout draws the same masks from torch's CUDA generator as the
    program's; in evaluation it is written out (projections, softmax,
    weighted sum, output projection)."""

    def __init__(self, d_model: int, heads: int, ffn: int,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d_model, heads, dropout=dropout,
                                               batch_first=True)
        self.linear1 = nn.Linear(d_model, ffn)
        self.linear2 = nn.Linear(ffn, d_model)
        self.norm1 = layer_norm(d_model)
        self.norm2 = layer_norm(d_model)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.heads = heads

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self.self_attn(x, x, x, need_weights=False)[0]
        a = self.self_attn
        b, n, d = x.shape
        hd = d // self.heads
        q, k, v = F.linear(x, a.in_proj_weight, a.in_proj_bias).chunk(3, -1)
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2)
                   for t in (q, k, v))
        w = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), -1)
        out = (w @ v).transpose(1, 2).reshape(b, n, d)
        return a.out_proj(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dropout1(self._attend(self.norm1(x)))
        h = self.linear2(self.dropout(F.relu(self.linear1(self.norm2(x)))))
        return x + self.dropout2(h)
