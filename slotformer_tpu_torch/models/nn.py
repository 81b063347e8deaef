"""NN building blocks: the part of ``slotformer_tpu/models/nn.py`` the
CLEVRER inference path uses.

Layouts: modules take NCHW feature maps inside; module names and parameter
shapes follow the reference torch checkpoints (``nn.Sequential`` indices
included), so ``load_state_dict`` takes reference weights as they are.

Numerics pinned to the JAX package:
  * every LayerNorm uses eps=1e-6, the flax default (torch's default is 1e-5),
    including the two inside each transformer layer;
  * ``ConvNormAct`` pads like XLA's ``SAME`` (equal to torch's ``k//2`` for
    stride 1 and an odd kernel, asymmetric for stride 2);
  * ``DeconvNormAct`` is ``ConvTranspose2d(k, s, padding=k//2,
    output_padding=s-1)``, which the JAX package reproduces exactly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import decoder_conv

LN_EPS = 1e-6


def LayerNorm(dim: int) -> nn.LayerNorm:
    """``nn.LayerNorm`` with the flax default eps (1e-6)."""
    return nn.LayerNorm(dim, eps=LN_EPS)


def _act(name: str) -> Optional[nn.Module]:
    if name and name != "relu":
        raise NotImplementedError(f"activation {name}")
    return nn.ReLU() if name else None


def _check_norm(name: str) -> None:
    # every config of the repo runs its convolutions without a norm
    if name:
        raise NotImplementedError(f"norm {name}")


class _SamePadConv2d(nn.Conv2d):
    """Conv2d with XLA ``SAME`` padding (asymmetric for even totals)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(x.shape[:1:-1], self.kernel_size[::-1],
                              self.stride[::-1]):
            out = -(-size // s)
            total = max((out - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class ConvNormAct(nn.Sequential):
    """Conv2d (+ activation) as ``Sequential(conv, [act])``, the reference's
    ``conv_norm_act`` key layout without a norm."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 1, norm: str = "",
                 act: str = "relu"):
        if stride == 1 and kernel_size % 2:
            conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                             padding=kernel_size // 2)
        else:
            conv = _SamePadConv2d(in_channels, out_channels, kernel_size,
                                  stride)
        _check_norm(norm)
        super().__init__(*[m for m in (conv, _act(act)) if m is not None])


class DeconvNormAct(nn.Sequential):
    """ConvTranspose2d (+ activation), reference geometry, no norm.

    A CUDA float32 input outside autocast, on a 64 -> 64 5x5 stride-1 layer
    with a ReLU (the SAVi decoder's last transposed convolution), runs kernel
    K3 (``kernels/decoder_conv.py``) in place of the two modules; everything
    else runs them as they are (``takes_decoder_conv``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 2, norm: str = "",
                 act: str = "relu"):
        deconv = nn.ConvTranspose2d(
            in_channels, out_channels, kernel_size, stride,
            padding=kernel_size // 2, output_padding=stride - 1)
        _check_norm(norm)
        super().__init__(*[m for m in (deconv, _act(act)) if m is not None])

    def takes_decoder_conv(self, x: torch.Tensor) -> bool:
        """Whether ``forward`` runs K3 on ``x``: all of the input's device,
        dtype and autocast state and the layer's geometry fit the kernel."""
        conv = self[0]
        return (x.device.type == "cuda" and x.dtype == torch.float32
                and not torch.is_autocast_enabled("cuda")
                and conv.kernel_size == (decoder_conv.KERNEL_SIZE,) * 2
                and conv.stride == (1, 1)
                and conv.padding == (decoder_conv.PADDING,) * 2
                and conv.output_padding == (0, 0) and conv.dilation == (1, 1)
                and conv.groups == 1
                and conv.in_channels == conv.out_channels == decoder_conv.CHANNELS
                and len(self) == 2 and isinstance(self[1], nn.ReLU))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.takes_decoder_conv(x):
            # the kernel reads channels-last memory, which the decoder's
            # activations already are (a copy otherwise)
            return decoder_conv.decoder_conv_s1(
                x.contiguous(memory_format=torch.channels_last), self[0].weight,
                self[0].bias)
        return super().forward(x)


class MLP(nn.Sequential):
    """Linear layers with an activation between them (none after the last);
    Sequential indices 0, 2, 4, ... hold the Linears."""

    def __init__(self, in_features: int, features: Sequence[int],
                 act: str = "relu"):
        layers = []
        for i, f in enumerate(features):
            layers.append(nn.Linear(in_features, f))
            if i != len(features) - 1:
                layers.append(_act(act))
            in_features = f
        super().__init__(*layers)


def build_grid(resolution: Tuple[int, int]) -> np.ndarray:
    """Normalized coordinate grid [1, H, W, 4] = (y, x, 1-y, 1-x)."""
    ranges = [np.linspace(0.0, 1.0, num=r, dtype=np.float32) for r in resolution]
    grid = np.stack(np.meshgrid(*ranges, indexing="ij"), axis=-1)
    grid = grid.reshape(resolution[0], resolution[1], -1)[None]
    return np.concatenate([grid, 1.0 - grid], axis=-1)


class SoftPositionEmbed(nn.Module):
    """Project the 4-dim coordinate grid and add it to an NCHW feature map.

    The grid is a buffer because reference checkpoints carry it.
    """

    def __init__(self, hidden_size: int, resolution: Tuple[int, int]):
        super().__init__()
        self.dense = nn.Linear(4, hidden_size)
        self.register_buffer("grid", torch.from_numpy(build_grid(resolution)))

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        emb = self.dense(self.grid).permute(0, 3, 1, 2)  # [1, C, H, W]
        return inputs + emb


def get_sin_pos_enc(seq_len: int, d_model: int) -> torch.Tensor:
    """Sinusoidal absolute PE, [1, L, D], positions in REVERSE order
    (L-1 .. 0) as the reference generates them."""
    inv_freq = 1.0 / (10000 ** (np.arange(0.0, d_model, 2.0) / d_model))
    pos_seq = np.arange(seq_len - 1, -1, -1, dtype=np.float32)
    sinusoid = np.outer(pos_seq, inv_freq)
    pos_emb = np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)
    return torch.from_numpy(pos_emb[None].astype(np.float32))


def PosEnc(kind: str, input_len: int, d_model: int) -> Optional[nn.Parameter]:
    """Positional table [1, L, D] as the reference's ``build_pos_enc`` makes
    it: a zero-initialised learnable Parameter (``'learnable'``, Aloe's), a
    frozen sinusoid (a Parameter with ``requires_grad=False``, so
    checkpoints carry it) or ``None`` for no encoding."""
    if not kind:
        return None
    if kind == "learnable":
        return nn.Parameter(torch.zeros(1, input_len, d_model))
    if "sin" in kind:
        return nn.Parameter(get_sin_pos_enc(input_len, d_model),
                            requires_grad=False)
    raise NotImplementedError(f"unsupported pos enc {kind}")


class TransformerEncoderLayer(nn.Module):
    """torch ``TransformerEncoderLayer`` semantics (batch-first, ReLU FFN,
    dropout 0.1 in training) with LayerNorm eps 1e-6 and pre- or post-LN.

    ``key_padding_mask``: [B, L], True = padded (ignored), torch convention.
    """

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 norm_first: bool = True, dropout: float = 0.1):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(
            d_model, num_heads, dropout=dropout, batch_first=True)
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.norm_first = norm_first

    def _sa(self, x, key_padding_mask):
        x = self.self_attn(x, x, x, key_padding_mask=key_padding_mask,
                           need_weights=False)[0]
        return self.dropout1(x)

    def _ff(self, x):
        x = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.dropout2(x)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.norm_first:
            x = x + self._sa(self.norm1(x), key_padding_mask)
            x = x + self._ff(self.norm2(x))
        else:
            x = self.norm1(x + self._sa(x, key_padding_mask))
            x = self.norm2(x + self._ff(x))
        return x


class TransformerEncoder(nn.Module):
    """Stack of encoder layers (keys ``layers.{i}.*``, no final norm)."""

    def __init__(self, d_model: int, num_layers: int, num_heads: int,
                 ffn_dim: int, norm_first: bool = True, dropout: float = 0.1):
        super().__init__()
        self.layers = nn.ModuleList([
            TransformerEncoderLayer(d_model, num_heads, ffn_dim, norm_first,
                                    dropout)
            for _ in range(num_layers)
        ])

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, key_padding_mask=key_padding_mask)
        return x
