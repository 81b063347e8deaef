"""SAVi transition predictors, the port of ``slotformer_tpu/models/predictor.py``.

Every predictor is ``(x, state) -> (out, state)`` with ``init_state``
giving the initial carry; the stateless ones carry ``()``. The LSTM wrapper
(``pred_rnn=True``) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
from torch import nn

from .nn import MLP, LayerNorm, TransformerEncoder

PredictorState = Any


class TransformerPredictor(nn.Module):
    """Encoder stack over the slot set (keys ``transformer_encoder.*``)."""

    def __init__(self, d_model: int = 128, num_layers: int = 1,
                 num_heads: int = 4, ffn_dim: int = 256,
                 norm_first: bool = True, dropout: float = 0.1):
        super().__init__()
        self.transformer_encoder = TransformerEncoder(
            d_model, num_layers, num_heads, ffn_dim, norm_first, dropout)

    def init_state(self, batch_size: int, num_tokens: int) -> PredictorState:
        return ()

    def forward(self, x: torch.Tensor, state: PredictorState = ()
                ) -> Tuple[torch.Tensor, PredictorState]:
        return self.transformer_encoder(x), state


class ResidualMLPPredictor(nn.Module):
    """LN then MLP with a residual; ``norm_first=True`` takes the residual
    after the LN (keys ``ln``, ``mlp.{0,2}``)."""

    def __init__(self, channels: Sequence[int], norm_first: bool = True):
        super().__init__()
        self.ln = LayerNorm(channels[0])
        self.mlp = MLP(channels[0], channels[1:])
        self.norm_first = norm_first

    def init_state(self, batch_size: int, num_tokens: int) -> PredictorState:
        return ()

    def forward(self, x: torch.Tensor, state: PredictorState = ()
                ) -> Tuple[torch.Tensor, PredictorState]:
        res = x
        x = self.ln(x)
        if self.norm_first:
            res = x
        return self.mlp(x) + res, state


def build_predictor(slot_size: int, slot_mlp_size: int, pred_dict: dict) -> nn.Module:
    """Assemble a predictor from the reference's ``pred_dict`` schema."""
    if pred_dict.get("pred_rnn", False):
        raise NotImplementedError(
            "pred_rnn=True (RNNPredictorWrapper) is not ported yet")
    if pred_dict.get("pred_type", "transformer") == "mlp":
        return ResidualMLPPredictor(
            channels=(slot_size, slot_size * 2, slot_size),
            norm_first=pred_dict.get("pred_norm_first", True))
    return TransformerPredictor(
        d_model=slot_size,
        num_layers=pred_dict.get("pred_num_layers", 1),
        num_heads=pred_dict.get("pred_num_heads", 4),
        ffn_dim=pred_dict.get("pred_ffn_dim", 256),
        norm_first=pred_dict.get("pred_norm_first", True))
