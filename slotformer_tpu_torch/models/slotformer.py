"""SlotFormer, the port of ``slotformer_tpu/models/slotformer.py``
(inference path: rollout and decode; the losses come later).

State-dict layout as the reference: ``rollouter.*`` plus the frozen SAVi
decoder's ``decoder.*`` and ``decoder_pos_embedding.*`` at the top level.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .nn import PosEnc, TransformerEncoder
from .savi import SpatialBroadcastDecoder, _adopt


class SlotRollouter(nn.Module):
    """Sliding-window autoregressive rollout: [B, history_len, N, C] ->
    [B, pred_len, N, C]. The transformer encoder is bidirectional within the
    window, so every step recomputes the whole window."""

    def __init__(self, num_slots: int, slot_size: int, history_len: int,
                 t_pe: str = "sin", slots_pe: str = "", d_model: int = 128,
                 num_layers: int = 4, num_heads: int = 8, ffn_dim: int = 512,
                 norm_first: bool = True, dropout: float = 0.1):
        super().__init__()
        self.num_slots = num_slots
        self.slot_size = slot_size
        self.history_len = history_len
        self.d_model = d_model
        self.in_proj = nn.Linear(slot_size, d_model)
        self.transformer_encoder = TransformerEncoder(
            d_model, num_layers, num_heads, ffn_dim, norm_first, dropout)
        self.out_proj = nn.Linear(d_model, slot_size)
        self.enc_t_pe = PosEnc(t_pe, history_len, d_model)
        self.enc_slots_pe = PosEnc(slots_pe, num_slots, d_model)

    def _pos_enc(self) -> torch.Tensor:
        """[1, history_len*N, d_model]: temporal PE repeated per slot (+ slot
        PE repeated per step)."""
        pe = torch.zeros(1, self.history_len, self.num_slots, self.d_model,
                         device=self.in_proj.weight.device)
        if self.enc_t_pe is not None:
            pe = pe + self.enc_t_pe[:, :, None, :]
        if self.enc_slots_pe is not None:
            pe = pe + self.enc_slots_pe[:, None, :, :]
        return pe.reshape(1, self.history_len * self.num_slots, self.d_model)

    def forward(self, x: torch.Tensor, pred_len: int) -> torch.Tensor:
        if x.shape[1] != self.history_len:
            raise ValueError(f"wrong burn-in steps {x.shape[1]}, expected "
                             f"{self.history_len}")
        B, N = x.shape[0], self.num_slots
        buf = x.reshape(B, self.history_len * N, x.shape[-1])
        pe = self._pos_enc().to(buf.dtype)
        preds = []
        for _ in range(pred_len):
            h = self.transformer_encoder(self.in_proj(buf) + pe)
            pred = self.out_proj(h[:, -N:])
            preds.append(pred)
            buf = torch.cat([buf[:, N:], pred], dim=1)
        return torch.stack(preds, 1)  # [B, pred_len, N, C]


class SlotFormer(nn.Module):
    """Rollouter + frozen SAVi decoder (constructor mirrors the reference's
    config-dict surface)."""

    def __init__(self, resolution: Tuple[int, int], clip_len: int = 16,
                 slot_dict: dict = None, dec_dict: dict = None,
                 rollout_dict: dict = None, loss_dict: dict = None,
                 eps: float = 1e-6):
        super().__init__()
        sd = slot_dict or {}
        self.resolution = tuple(resolution)
        self.clip_len = clip_len
        self.num_slots = sd.get("num_slots", 7)
        self.slot_size = sd.get("slot_size", 128)
        _adopt(self, "spatial_decoder", SpatialBroadcastDecoder(
            self.resolution, self.slot_size, dec_dict))
        rd = dict(rollout_dict or {})
        self.history_len = rd.get("history_len", 6)
        self.rollouter = SlotRollouter(**rd)
        ld = loss_dict or {}
        self.rollout_len = ld.get("rollout_len", 6)
        self.use_img_recon_loss = ld.get("use_img_recon_loss", False)

    def decode(self, slots: torch.Tensor):
        """Decode slots through the (frozen) SAVi decoder."""
        return self.spatial_decoder(slots)

    def rollout(self, past_slots: torch.Tensor, pred_len: int,
                decode: bool = False, with_gt: bool = True):
        """Unroll ``pred_len`` steps from [B, T, N, C]; with ``decode`` also
        decode (the history too when ``with_gt``) to NHWC pixels."""
        B = past_slots.shape[0]
        pred_slots = self.rollouter(past_slots[:, -self.history_len:], pred_len)
        if not decode:
            return pred_slots
        slots = torch.cat([past_slots, pred_slots], 1) if with_gt else pred_slots
        T = slots.shape[1]
        recon_combined, recons, masks, _ = self.decode(
            slots.reshape(B * T, self.num_slots, self.slot_size))
        return {
            "recon_combined": recon_combined.reshape(B, T, *recon_combined.shape[1:]),
            "recons": recons.reshape(B, T, *recons.shape[1:]),
            "masks": masks.reshape(B, T, *masks.shape[1:]),
            "slots": slots,
        }

    def forward(self, batch: dict) -> dict:
        slots = batch["slots"]  # [B, T, N, C]
        if slots.shape[1] != self.history_len + self.rollout_len:
            raise ValueError(f"wrong SlotFormer clip length {slots.shape[1]}")
        past_slots = slots[:, :self.history_len]
        gt_slots = slots[:, self.history_len:]
        if self.use_img_recon_loss:
            out = self.rollout(past_slots, self.rollout_len, decode=True,
                               with_gt=False)
            out["pred_slots"] = out.pop("slots")
            out["gt_slots"] = gt_slots
            return out
        return {"gt_slots": gt_slots,
                "pred_slots": self.rollout(past_slots, self.rollout_len)}
