"""Slot Attention, the port of ``slotformer_tpu/models/slot_attention.py``.

Parameter names follow the reference (``norm_inputs``, ``project_q.{0,1}``,
``project_k``, ``project_v``, ``gru``, ``mlp.{0,1,3}``). The iteration loop
is kernel K1 (``kernels.slot_attention.fused_slot_attention``), which
launches the CUDA kernel for CUDA tensors and runs its plain version for CPU
tensors; it computes the same function as the JAX module's jnp loop. The
kernel takes the weights packed into its own buffers: ``packed_weights``
builds them, and a caller that runs the module several times on unchanged
parameters (``StoSAVi.encode`` over the frames of a clip) packs once and
passes the result to every call. ``SlotAttentionWMask`` (STEVE) also
returns the kernel's second output, the last round's attention, as the
slots' segmentation masks.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels.slot_attention import fused_slot_attention, pack_weights
from .nn import LayerNorm


class SlotAttention(nn.Module):
    """Returns the refined slots [B, S, D] (SAVi path)."""

    def __init__(self, in_features: int, num_iterations: int, num_slots: int,
                 slot_size: int, mlp_hidden_size: int, eps: float = 1e-6):
        super().__init__()
        self.num_iterations = num_iterations
        self.num_slots = num_slots
        self.slot_size = slot_size
        self.eps = eps
        self.norm_inputs = LayerNorm(in_features)
        self.project_q = nn.Sequential(
            LayerNorm(slot_size), nn.Linear(slot_size, slot_size, bias=False))
        self.project_k = nn.Linear(in_features, slot_size, bias=False)
        self.project_v = nn.Linear(in_features, slot_size, bias=False)
        self.gru = nn.GRUCell(slot_size, slot_size)
        self.mlp = nn.Sequential(
            LayerNorm(slot_size), nn.Linear(slot_size, mlp_hidden_size),
            nn.ReLU(), nn.Linear(mlp_hidden_size, slot_size))

    def project_kv(self, inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Input LN + k/v projection, exposed so ``StoSAVi.encode`` runs it
        once over all frames."""
        x = self.norm_inputs(inputs)
        return self.project_k(x), self.project_v(x)

    def fused_weights(self) -> Dict[str, torch.Tensor]:
        """The weights in the kernel's layout (``[in, out]`` matrices, flax
        GRU gates with the hidden r/z biases folded into the input ones);
        differentiable with respect to the module's parameters."""
        D = self.slot_size
        w_ir, w_iz, w_in = self.gru.weight_ih.t().split(D, dim=1)
        w_hr, w_hz, w_hn = self.gru.weight_hh.t().split(D, dim=1)
        b_ir, b_iz, b_in = self.gru.bias_ih.split(D)
        b_hr, b_hz, b_hn = self.gru.bias_hh.split(D)
        q_ln, q_proj = self.project_q
        mlp_ln, mlp_hidden, _, mlp_out = self.mlp
        return dict(
            q_ln_scale=q_ln.weight, q_ln_bias=q_ln.bias, wq=q_proj.weight.t(),
            w_ir=w_ir, w_iz=w_iz, w_in=w_in, w_hr=w_hr, w_hz=w_hz, w_hn=w_hn,
            b_ir=b_ir + b_hr, b_iz=b_iz + b_hz, b_in=b_in, b_hn=b_hn,
            mlp_ln_scale=mlp_ln.weight, mlp_ln_bias=mlp_ln.bias,
            w1=mlp_hidden.weight.t(), b1=mlp_hidden.bias,
            w2=mlp_out.weight.t(), b2=mlp_out.bias,
        )

    def packed_weights(self) -> Dict[str, torch.Tensor]:
        """``fused_weights`` in float32, packed into kernel K1's buffers;
        differentiable with respect to the module's parameters. Valid until
        the parameters change: pack anew after every optimizer step."""
        device = self.gru.weight_ih.device.type
        with torch.autocast(device, enabled=False):
            return pack_weights(
                {n: w.float() for n, w in self.fused_weights().items()})

    def _run(self, inputs: Optional[torch.Tensor], slots: torch.Tensor,
             kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             weights: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(slots [B, S, D], last-round attention [B, N, S]) through K1.

        ``inputs`` [B, N, C] or precomputed ``kv`` = (k, v) [B, N, D];
        ``slots`` [B, S, D] init; ``weights``: the result of
        ``packed_weights``, packed here when not given.

        K1 computes in float32, as the JAX fused kernel does: under autocast
        its inputs are cast to float32 and the slots back to k's dtype.
        """
        k, v = self.project_kv(inputs) if kv is None else kv
        if weights is None:
            weights = self.packed_weights()
        with torch.autocast(k.device.type, enabled=False):
            out, attn = fused_slot_attention(
                k.float(), v.float(), slots.float().contiguous(), weights,
                self.num_iterations, self.num_slots, self.slot_size ** -0.5,
                self.eps)
        return out.to(k.dtype), attn

    def forward(self, inputs: Optional[torch.Tensor], slots: torch.Tensor,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                weights: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """The refined slots [B, S, D]; arguments as ``_run``."""
        return self._run(inputs, slots, kv, weights)[0]


class SlotAttentionWMask(SlotAttention):
    """Also returns the last round's attention as segmentation masks."""

    def forward(self, inputs: Optional[torch.Tensor], slots: torch.Tensor,
                kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                weights: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(slots [B, S, D], masks [B, S, N]); arguments as ``_run``."""
        slots, attn = self._run(inputs, slots, kv, weights)
        return slots, attn.to(slots.dtype).transpose(1, 2)
