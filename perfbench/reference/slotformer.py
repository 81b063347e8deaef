"""SlotFormer (a transformer that rolls slots out autoregressively), plain
float32.

The published model: the last ``history_len`` frames of slots, each slot
projected to ``d_model`` and given the sinusoid of its frame (positions
counted from the newest frame back), go through a stack of pre-LN
transformer layers over all slots of the window; the outputs of the newest
frame's slots are projected back to slots and become the next frame,
which enters the window as the oldest frame leaves it. The frozen
spatial-broadcast decoder of the slot encoder renders slots to frames.
Training loss: the MSE of the rolled-out slots against the true ones plus
the MSE of the decoded rollout against the true frames; the decoder gets
no gradient, so the image loss is taken chunk by chunk, each chunk's
gradient with respect to its slots right after its decode.

Keys: ``rollouter.*`` and the decoder's ``decoder.*``,
``decoder_pos_embedding.*``.
"""

from __future__ import annotations

import torch
from torch import nn

from .nn import BroadcastDecoder, EncoderLayer, sin_table


class Rollouter(nn.Module):
    def __init__(self, rd: dict):
        super().__init__()
        if rd["slots_pe"] or rd["t_pe"] != "sin" or not rd["norm_first"]:
            raise NotImplementedError("sin temporal PE, pre-LN layers only")
        self.S, self.hist, self.d = rd["num_slots"], rd["history_len"], rd["d_model"]
        self.enc_t_pe = nn.Parameter(sin_table(self.hist, self.d),
                                     requires_grad=False)
        self.in_proj = nn.Linear(rd["slot_size"], self.d)
        self.transformer_encoder = nn.Module()
        self.transformer_encoder.layers = nn.ModuleList(
            EncoderLayer(self.d, rd["num_heads"], rd["ffn_dim"])
            for _ in range(rd["num_layers"]))
        self.out_proj = nn.Linear(self.d, rd["slot_size"])

    def forward(self, past: torch.Tensor, steps: int) -> torch.Tensor:
        """[B, history_len, S, C] -> [B, steps, S, C]."""
        b = past.shape[0]
        pe = self.enc_t_pe[:, :, None, :].expand(1, self.hist, self.S, self.d)
        pe = pe.reshape(1, self.hist * self.S, self.d)
        window = past.reshape(b, self.hist * self.S, past.shape[-1])
        preds = []
        for _ in range(steps):
            h = self.in_proj(window) + pe
            for layer in self.transformer_encoder.layers:
                h = layer(h)
            pred = self.out_proj(h[:, -self.S:])
            preds.append(pred)
            window = torch.cat([window[:, self.S:], pred], 1)
        return torch.stack(preds, 1)


class SlotFormer(nn.Module):
    def __init__(self, p: dict):
        super().__init__()
        dd, ld = p["dec_dict"], p["loss_dict"]
        if dd["dec_norm"]:
            raise NotImplementedError("norm-free decoder only")
        self.S = p["slot_dict"]["num_slots"]
        self.D = p["slot_dict"]["slot_size"]
        self.rollouter = Rollouter(p["rollout_dict"])
        dec = BroadcastDecoder(self.D, dd["dec_channels"],
                               dd["dec_resolution"][0], dd["dec_ks"],
                               p["resolution"][0])
        self.decoder = dec.decoder
        self.decoder_pos_embedding = dec.decoder_pos_embedding
        object.__setattr__(self, "dec", dec)
        self.hist = p["rollout_dict"]["history_len"]
        self.rollout_len = ld["rollout_len"]
        self.use_img_recon_loss = ld["use_img_recon_loss"]
        # frames a chunk of the image loss decodes at once (memory only)
        self.chunk_frames = 160

    def rollout_decode(self, slots: torch.Tensor, steps: int) -> dict:
        """Evaluation: [B, >= history_len, S, C] -> rolled-out slots [B,
        steps, S, C], their frames [B, steps, H, W, 3] and masks [B, steps,
        S, H, W, 1]."""
        b = slots.shape[0]
        pred = self.rollouter(slots[:, :self.hist], steps)
        recon, masks = self.dec(pred.reshape(b * steps, self.S, self.D))
        return {"pred_slots": pred,
                "recon_combined": recon.reshape(b, steps, *recon.shape[1:]),
                "masks": masks.reshape(b, steps, *masks.shape[1:])}

    def _image_loss(self, pred: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """mean((decode(pred) - img)^2) with the decoder frozen (its
        parameters need ``requires_grad`` off, as the trainer sets it); its
        value with the gradient it sends to ``pred``, one chunk decoded at a
        time."""
        flat = pred.reshape(-1, self.S, self.D)
        gt = img.reshape(-1, *img.shape[2:])
        return _FrozenImageLoss.apply(flat, gt, self.dec, self.chunk_frames)

    def train_loss(self, batch: dict, generator=None) -> dict:
        slots = batch["slots"]
        pred = self.rollouter(slots[:, :self.hist], self.rollout_len)
        losses = {"slot_recon_loss": ((pred - slots[:, self.hist:]) ** 2).mean()}
        if self.use_img_recon_loss:
            losses["img_recon_loss"] = self._image_loss(
                pred, batch["img"][:, self.hist:])
        return losses


class _FrozenImageLoss(torch.autograd.Function):
    """Sum over chunks of the decoded squared error, divided by the pixel
    count; backward returns d(loss)/d(slots), kept from the forward."""

    @staticmethod
    def forward(ctx, slots, gt, dec, chunk):
        total = slots.new_zeros(())
        grads = []
        for s, g in zip(slots.split(chunk), gt.split(chunk)):
            with torch.enable_grad():
                s = s.detach().requires_grad_(True)
                sse = ((dec(s)[0] - g) ** 2).sum()
                sse.backward()
                grads.append(s.grad)
            total = total + sse.detach()
        n = gt.numel()
        ctx.save_for_backward(torch.cat(grads) / n)
        return total / n

    @staticmethod
    def backward(ctx, g):
        (dslots,) = ctx.saved_tensors
        return dslots * g, None, None, None


def build(params: dict) -> SlotFormer:
    return SlotFormer(params)
