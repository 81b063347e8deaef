"""STEVE, the port of ``slotformer_tpu/models/steve.py``: a slot encoder with
a Transformer token decoder.

The encoder is StoSAVi's with deterministic latents: the predictor's output
seeds slot attention directly (no kernel head), and slot attention is
``SlotAttentionWMask``, whose masks are kernel K1's second output, the last
round's attention. A frozen dVAE turns frames into token ids (or the loader
supplies them as ``token_id``); the token decoder predicts them from the
slots under teacher forcing, with a cross-entropy loss (and, with
``use_img_recon_loss``, an MSE on the dVAE-decoded gumbel-softmax tokens at
tau 0.1).

State-dict layout as the reference: the encoder's and the cell's parts at
the top level (``init_latents``, ``encoder.*``, ``encoder_pos_embedding.*``,
``encoder_out_layer.*``, ``slot_attention.*``, ``predictor.*``; see
``savi._adopt``), then ``dvae.*`` and ``trans_decoder.*``.

``img`` is NHWC ``[B, T, H, W, 3]`` in [-1, 1]; token ids are flattened
row-major to ``[B, T, h*w]``, the on-disk Physion token contract. In eval
mode ``forward`` upsamples the masks bilinearly to the input resolution
(half-pixel centres, as ``jax.image.resize``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .dvae import dVAE, gumbel_softmax
from .savi import FrameEncoder, SAViCell, _adopt, encode_frames
from .steve_transformer import STEVETransformerDecoder


def token_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` [.., vocab] against ids [..]."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           target.reshape(-1))


class STEVE(nn.Module):
    """Constructor mirrors the reference's config-dict surface."""

    def __init__(self, resolution: Tuple[int, int], clip_len: int = 6,
                 slot_dict: dict = None, dvae_dict: dict = None,
                 enc_dict: dict = None, dec_dict: dict = None,
                 pred_dict: dict = None, loss_dict: dict = None,
                 eps: float = 1e-6):
        super().__init__()
        sd, ed = slot_dict or {}, enc_dict or {}
        dv, dd = dvae_dict or {}, dec_dict or {}
        self.resolution = tuple(resolution)
        self.clip_len = clip_len
        self.num_slots = sd.get("num_slots", 7)
        self.slot_size = sd.get("slot_size", 128)
        self.vocab_size = dv.get("vocab_size", 4096)
        down = dv.get("down_factor", 4)
        self.h, self.w = self.resolution[0] // down, self.resolution[1] // down
        self.num_patches = self.h * self.w
        stride0 = 2 if self.resolution[0] == 128 else 1
        self.visual_resolution = (self.resolution[0] // stride0,
                                  self.resolution[1] // stride0)
        self.use_img_recon_loss = (loss_dict or {}).get(
            "use_img_recon_loss", False)

        self.init_latents = nn.Parameter(
            torch.randn(1, self.num_slots, self.slot_size))
        _adopt(self, "frame_encoder", FrameEncoder(self.resolution, ed))
        _adopt(self, "cell", SAViCell(
            slot_size=self.slot_size,
            slot_mlp_size=sd.get("slot_mlp_size", 256),
            num_slots=self.num_slots,
            num_iterations=sd.get("num_iterations", 2),
            in_features=ed.get("enc_out_channels", 128),
            pred_dict=pred_dict or dict(pred_type="transformer", pred_rnn=True),
            kernel_mlp=False, stochastic=False, with_mask=True,
            use_kernel_head=False, eps=eps))
        self.dvae = dVAE(vocab_size=self.vocab_size, img_channels=3)
        self.trans_decoder = STEVETransformerDecoder(
            vocab_size=self.vocab_size, d_model=dd.get("dec_d_model", 128),
            n_head=dd.get("dec_num_heads", 4), max_len=self.num_patches - 1,
            num_slots=self.num_slots, num_layers=dd.get("dec_num_layers", 4))

    def init_pred_state(self, batch_size: int):
        return self.cell.predictor.init_state(batch_size, self.num_slots)

    def encode(self, img: torch.Tensor, prev_slots: Optional[torch.Tensor] = None,
               pred_state=None, upsample_masks: bool = False):
        """[B, T, H, W, 3] -> (slots [B, T, S, D], masks [B, T, S, h', w'],
        encoder_out [B, T, h'*w', C], carry). The masks are at the
        encoder's resolution, or the input's with ``upsample_masks``.
        ``prev_slots``/``pred_state`` (the ``carry`` of the previous call)
        continue a chunked long video."""
        B, T = img.shape[:2]
        _, slots, masks, feats, carry = encode_frames(self, img, prev_slots,
                                                      pred_state)
        masks = masks.reshape(B, T, self.num_slots, *self.visual_resolution)
        if upsample_masks and self.visual_resolution != self.resolution:
            masks = F.interpolate(
                masks.reshape(B * T, self.num_slots, *self.visual_resolution),
                size=self.resolution, mode="bilinear", align_corners=False,
            ).reshape(B, T, self.num_slots, *self.resolution)
        return slots, masks, feats, carry

    def forward(self, batch: dict, testing: bool = False,
                generator: Optional[torch.Generator] = None,
                uniform: Optional[torch.Tensor] = None) -> dict:
        """``slots`` and ``masks`` (upsampled in eval mode); unless
        ``testing``, also the token logits ``pred_token_id`` [B*T, h*w,
        vocab] and their targets, and with ``use_img_recon_loss``
        ``recon_img`` / ``gt_img``. The gumbel noise of the image branch
        comes from ``generator`` or ``uniform``."""
        img = batch["img"]
        B, T = img.shape[:2]
        slots, masks, _, _ = self.encode(img, upsample_masks=not self.training)
        out = {"slots": slots, "masks": masks}
        if testing:
            return out
        token_id = batch.get("token_id")
        if token_id is None:
            with torch.no_grad():
                token_id = self.dvae.tokenize(img, one_hot=False)
        target = token_id.reshape(B * T, self.num_patches).long()
        in_slots = slots.reshape(B * T, self.num_slots, self.slot_size)
        logits = self.trans_decoder(in_slots, target[:, :-1])[:, -self.num_patches:]
        out["pred_token_id"] = logits
        out["target_token_id"] = target
        if self.use_img_recon_loss:
            out["gt_img"] = img.reshape(B * T, *img.shape[2:])
            z_logits = F.log_softmax(logits, dim=-1).reshape(
                B * T, self.h, self.w, self.vocab_size)
            z = gumbel_softmax(z_logits, 0.1, False, -1, generator, uniform)
            out["recon_img"] = self.dvae.detokenize(z)
        return out

    def calc_train_loss(self, batch: dict, out: dict) -> dict:
        loss = {"token_recon_loss": token_cross_entropy(
            out["pred_token_id"], out["target_token_id"])}
        if self.use_img_recon_loss:
            loss["img_recon_loss"] = (
                (out["recon_img"] - out["gt_img"]) ** 2).mean()
        return loss

    def train_loss(self, batch: dict,
                   generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` (call in ``train()`` mode)."""
        return self.calc_train_loss(batch, self(batch, generator=generator))

    def eval_loss(self, batch: dict,
                  generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` (call in ``eval()`` mode)."""
        return self.calc_train_loss(batch, self(batch, generator=generator))
