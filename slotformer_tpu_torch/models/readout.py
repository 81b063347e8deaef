"""Readout heads, the port of ``slotformer_tpu/models/readout.py``: the PHYRE
task-success classifier and the Physion relation readout.

  * ``PHYREReadout`` (reference phyre_planning/models/readout.py): a
    transformer encoder over the slots of the timesteps ``sel_slots``
    (default [0, 3]) with a temporal positional encoding and a zero-init
    CLS token -> one logit;
  * ``PhysionReadout`` (reference physion_vqa/models/readout.py): every
    C(N, 2) slot pair -> linear -> aggregate over the pairs (sum, mean or
    max) -> linear -> max over time.

Both train with a binary cross-entropy and add an accuracy at each of the
thresholds 0.1, 0.3, ..., 0.9 in evaluation. Key layout as the reference:
``CLS``, ``enc_t_pe``, ``in_proj``, ``transformer_encoder.layers.*`` and
``cls_mlp.0`` / ``cls_mlp.2``; ``linear1``, ``linear2`` and the int64
buffer ``comb_idx`` (the pairs, flattened).

The first projection of each head (``in_proj``, ``linear1``) takes raw slot
features, whose informative directions can lie far below the per-channel
offsets; it runs in float32 with autocast off (the JAX package pins it to
``Precision.HIGHEST``), so that rounding does not swamp them and a
standardization folded into its weights stays exact.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .nn import PosEnc, TransformerEncoder


def _f32_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` in float32 with autocast off."""
    with torch.autocast(x.device.type, enabled=False):
        return F.linear(x.float(), layer.weight.float(), layer.bias.float())


def _bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def _acc_sweep(logits: torch.Tensor, labels: torch.Tensor,
               out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    probs = torch.sigmoid(logits)
    for thresh in np.arange(0.1, 1, 0.2):
        out[f"acc_{thresh:.2f}"] = (
            (probs > float(thresh)).float() == labels).float().mean()
    return out


class _BinaryReadout(nn.Module):
    """The loss-dict methods shared by both heads (``forward`` gives
    ``{'logits': [B]}``)."""

    def calc_train_loss(self, batch: dict, out: dict) -> Dict[str, torch.Tensor]:
        labels = batch["label"].reshape(-1).float()
        return {"vqa_loss": _bce_with_logits(out["logits"].reshape(-1).float(),
                                             labels)}

    def train_loss(self, batch: dict,
                   generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` (call in ``train()`` mode; dropout
        draws from torch's global RNG; ``generator`` is the trainer's and is
        not used)."""
        return self.calc_train_loss(batch, self(batch))

    def eval_loss(self, batch: dict,
                  generator: Optional[torch.Generator] = None) -> dict:
        """The loss and the ``acc_*`` threshold sweep (call in ``eval()``
        mode)."""
        out = self(batch)
        losses = self.calc_train_loss(batch, out)
        return _acc_sweep(out["logits"].reshape(-1).float(),
                          batch["label"].reshape(-1).float(), losses)


class PHYREReadout(_BinaryReadout):

    def __init__(self, readout_dict: dict = None):
        super().__init__()
        rd = readout_dict or {}
        self.num_slots = rd.get("num_slots", 8)
        self.slot_size = rd.get("slot_size", 128)
        self.sel_slots = tuple(rd.get("sel_slots", (0, 3)))
        self.d_model = d_model = rd.get("d_model", 128)
        self.in_proj = nn.Linear(self.slot_size, d_model)
        self.CLS = nn.Parameter(torch.zeros(1, 1, d_model))
        self.transformer_encoder = TransformerEncoder(
            d_model, rd.get("num_layers", 4), rd.get("num_heads", 8),
            rd.get("ffn_dim", 512), rd.get("norm_first", True))
        self.enc_t_pe = PosEnc(rd.get("t_pe", "sin"), len(self.sel_slots),
                               d_model)
        self.cls_mlp = nn.Sequential(nn.Linear(d_model, d_model), nn.ReLU(),
                                     nn.Linear(d_model, 1))

    def forward(self, batch: dict) -> Dict[str, torch.Tensor]:
        slots = batch["slots"][:, list(self.sel_slots)]  # [B, T, N, C]
        x = _f32_linear(slots, self.in_proj)  # [B, T, N, D]
        B, T, N, D = x.shape
        if self.enc_t_pe is not None:
            x = x + self.enc_t_pe[:, :, None, :].to(x.dtype)
        x = torch.cat([self.CLS.expand(B, 1, D).to(x.dtype),
                       x.reshape(B, T * N, D)], dim=1)
        x = self.transformer_encoder(x)
        return {"logits": self.cls_mlp(x[:, 0])[:, 0]}  # [B]


class PhysionReadout(_BinaryReadout):

    def __init__(self, readout_dict: dict = None):
        super().__init__()
        rd = readout_dict or {}
        self.num_slots = rd.get("num_slots", 6)
        self.slot_size = rd.get("slot_size", 192)
        self.agg_func = rd.get("agg_func", "max")
        if self.agg_func not in ("sum", "mean", "max"):
            raise ValueError(f"agg_func {self.agg_func!r}")
        feats_dim = rd.get("feats_dim", 192)
        combs = list(combinations(range(self.num_slots), 2))
        self.register_buffer("comb_idx",
                             torch.tensor(combs, dtype=torch.int64).reshape(-1))
        self.linear1 = nn.Linear(2 * self.slot_size, feats_dim)
        self.linear2 = nn.Linear(feats_dim, 1)

    def forward(self, batch: dict) -> Dict[str, torch.Tensor]:
        slots = batch["slots"]  # [B, T, N, C]
        B, T, N, C = slots.shape
        pairs = slots[:, :, self.comb_idx].reshape(B, T, -1, 2 * C)
        rel = _f32_linear(pairs, self.linear1)  # [B, T, num_combs, F]
        if self.agg_func == "sum":
            rel = rel.sum(2)
        elif self.agg_func == "mean":
            rel = rel.mean(2)
        else:
            rel = rel.amax(2)
        logits = self.linear2(rel)[..., 0]  # [B, T]
        return {"logits": logits.amax(1)}  # a contact at ANY timestep
