"""SAVi transition predictors, the port of ``slotformer_tpu/models/predictor.py``.

Every predictor is ``(x, state) -> (out, state)`` with ``init_state``
giving the initial carry; the stateless ones carry ``()``, the LSTM wrapper
(``pred_rnn=True``) ``(c, h, step)`` as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

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


class RNNPredictorWrapper(nn.Module):
    """Base predictor -> one LSTM step per frame over the B*N flattened slot
    tokens -> projection (keys ``base_predictor.*``, ``rnn.*_l0``,
    ``out_projector``).

    The state is ``(c, h, step)`` as in the JAX package (torch's LSTM takes
    ``(h, c)``). ``sg_every=k`` detaches the input and the state every k
    steps (truncated backpropagation); the step index rides in the state.
    """

    def __init__(self, base: nn.Module, input_size: int = 128,
                 hidden_size: int = 256, sg_every: Optional[int] = None):
        super().__init__()
        self.base_predictor = base
        self.rnn = nn.LSTM(input_size, hidden_size)
        self.out_projector = nn.Linear(hidden_size, input_size)
        self.hidden_size = hidden_size
        self.sg_every = sg_every

    def init_state(self, batch_size: int, num_tokens: int) -> PredictorState:
        w = self.out_projector.weight
        c = w.new_zeros(batch_size * num_tokens, self.hidden_size)
        return (c, torch.zeros_like(c), 0)

    def forward(self, x: torch.Tensor, state: PredictorState
                ) -> Tuple[torch.Tensor, PredictorState]:
        c, h, step = state
        if self.sg_every is not None and step > 0 and step % self.sg_every == 0:
            x, c, h = x.detach(), c.detach(), h.detach()
        out, _ = self.base_predictor(x, ())
        shape = out.shape
        flat, (h, c) = self.rnn(out.reshape(1, -1, shape[-1]),
                                (h[None], c[None]))
        out = self.out_projector(flat[0]).reshape(shape)
        return out, (c[0], h[0], step + 1)


def build_predictor(slot_size: int, slot_mlp_size: int, pred_dict: dict) -> nn.Module:
    """Assemble a predictor from the reference's ``pred_dict`` schema."""
    if pred_dict.get("pred_type", "transformer") == "mlp":
        base = ResidualMLPPredictor(
            channels=(slot_size, slot_size * 2, slot_size),
            norm_first=pred_dict.get("pred_norm_first", True))
    else:
        base = TransformerPredictor(
            d_model=slot_size,
            num_layers=pred_dict.get("pred_num_layers", 1),
            num_heads=pred_dict.get("pred_num_heads", 4),
            ffn_dim=pred_dict.get("pred_ffn_dim", 256),
            norm_first=pred_dict.get("pred_norm_first", True))
    if not pred_dict.get("pred_rnn", False):
        return base
    return RNNPredictorWrapper(base, input_size=slot_size,
                               hidden_size=slot_mlp_size,
                               sg_every=pred_dict.get("pred_sg_every", None))
