"""STEVESlotFormer, the port of ``slotformer_tpu/models/steve_slotformer.py``:
SlotFormer's rollouter with a frozen dVAE and a frozen STEVE token decoder as
the pixel decoder.

State-dict layout as the reference: ``rollouter.*``, ``dvae.*`` (encoder and
decoder) and ``decoder.*``, the token decoder (the reference deep-copies
STEVE's ``trans_decoder`` under that name; the JAX package keeps
``trans_decoder``, and ``runtime.weights`` maps between the two).

``decode`` generates every one of the ``h*w`` tokens of an image with the
decoder's KV-cached ``generate`` (greedy), then detokenizes both the
gumbel-softmax tokens at tau 0.1 (``soft``) and the one-hot argmax tokens
(``hard``). With neither a generator nor ``uniform`` given, the gumbel noise
comes from a generator seeded with 0, as the JAX package draws it from
``PRNGKey(0)`` when no ``sample`` stream is given.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .dvae import dVAE, gumbel_softmax, make_one_hot
from .slotformer import SlotRollouter
from .steve import token_cross_entropy
from .steve_transformer import STEVETransformerDecoder


class STEVESlotFormer(nn.Module):
    """Constructor mirrors the reference's config-dict surface."""

    def __init__(self, resolution: Tuple[int, int], clip_len: int = 16,
                 slot_dict: dict = None, dvae_dict: dict = None,
                 dec_dict: dict = None, rollout_dict: dict = None,
                 loss_dict: dict = None, eps: float = 1e-6):
        super().__init__()
        sd, dv, dd = slot_dict or {}, dvae_dict or {}, dec_dict or {}
        self.resolution = tuple(resolution)
        self.clip_len = clip_len
        self.num_slots = sd.get("num_slots", 6)
        self.slot_size = sd.get("slot_size", 192)
        self.vocab_size = dv.get("vocab_size", 4096)
        down = dv.get("down_factor", 4)
        self.h, self.w = self.resolution[0] // down, self.resolution[1] // down
        self.num_patches = self.h * self.w
        self.dvae = dVAE(vocab_size=self.vocab_size, img_channels=3)
        self.decoder = STEVETransformerDecoder(
            vocab_size=self.vocab_size, d_model=dd.get("dec_d_model", 192),
            n_head=dd.get("dec_num_heads", 4), max_len=self.num_patches - 1,
            num_slots=self.num_slots, num_layers=dd.get("dec_num_layers", 4))
        rd = dict(rollout_dict or {})
        self.history_len = rd.get("history_len", 6)
        self.rollouter = SlotRollouter(**rd)
        ld = loss_dict or {}
        self.rollout_len = ld.get("rollout_len", 6)
        self.use_img_recon_loss = ld.get("use_img_recon_loss", False)

    def decode(self, slots: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               uniform: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, N, C] slots -> (soft, hard) NHWC images [B, H, W, 3]."""
        _, logits = self.decoder.generate(slots, steps=self.num_patches)
        logits = logits.reshape(-1, self.h, self.w, self.vocab_size)
        if generator is None and uniform is None:
            generator = torch.Generator(slots.device).manual_seed(0)
        z = gumbel_softmax(F.log_softmax(logits, dim=-1), 0.1, False, -1,
                           generator, uniform)
        return self.dvae.detokenize(z), self.dvae.detokenize(make_one_hot(logits))

    def rollout(self, past_slots: torch.Tensor, pred_len: int,
                decode: bool = False, with_gt: bool = True,
                generator: Optional[torch.Generator] = None):
        """Unroll ``pred_len`` steps from [B, T, N, C]; with ``decode`` also
        decode (the history too when ``with_gt``) to ``recon_combined``
        [B, T', H, W, 3], the soft reconstructions."""
        pred_slots = self.rollouter(past_slots[:, -self.history_len:], pred_len)
        if not decode:
            return pred_slots
        slots = torch.cat([past_slots, pred_slots], 1) if with_gt else pred_slots
        B, T = slots.shape[:2]
        soft, _ = self.decode(slots.reshape(B * T, self.num_slots, self.slot_size),
                              generator)
        return {"recon_combined": soft.reshape(B, T, *soft.shape[1:]),
                "slots": slots}

    def forward(self, batch: dict) -> dict:
        slots = batch["slots"]  # [B, history + rollout, N, C]
        if slots.shape[1] != self.history_len + self.rollout_len:
            raise ValueError(f"wrong STEVESlotFormer clip length {slots.shape[1]}")
        gt_slots = slots[:, self.history_len:]
        pred_slots = self.rollout(slots[:, :self.history_len], self.rollout_len)
        out = {"gt_slots": gt_slots, "pred_slots": pred_slots}
        if self.use_img_recon_loss:
            # a token cross-entropy of the ROLLED-OUT slots
            B, T = pred_slots.shape[:2]
            token_id = batch.get("token_id")
            if token_id is None:
                with torch.no_grad():
                    token_id = self.dvae.tokenize(
                        batch["img"][:, self.history_len:], one_hot=False)
            target = token_id.reshape(B * T, self.num_patches).long()
            in_slots = pred_slots.reshape(B * T, self.num_slots, self.slot_size)
            out["pred_token_id"] = self.decoder(
                in_slots, target[:, :-1])[:, -self.num_patches:]
            out["target_token_id"] = target
        return out

    def calc_train_loss(self, batch: dict, out: dict) -> dict:
        loss = {"slot_recon_loss":
                ((out["pred_slots"] - out["gt_slots"]) ** 2).mean()}
        if self.use_img_recon_loss and "pred_token_id" in out:
            loss["img_recon_loss"] = token_cross_entropy(
                out["pred_token_id"], out["target_token_id"])
        return loss

    def train_loss(self, batch: dict,
                   generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` (call in ``train()`` mode)."""
        return self.calc_train_loss(batch, self(batch))

    def eval_loss(self, batch: dict,
                  generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` (call in ``eval()`` mode)."""
        return self.calc_train_loss(batch, self(batch))
