"""StoSAVi (SAVi with stochastic slot-attention kernels), plain float32.

The published model: a CNN encoder over each frame, a coordinate
embedding and an LN-MLP head give N = H * W features; each frame step
predicts the slots' next state (residual LN-MLP predictor), maps it to the
mean and log-variance of the slot-attention kernels, samples them with
noise from a ``torch.Generator`` (one [B, S, D] draw a frame step), and
runs ``num_iterations`` rounds of slot attention (softmax over the slots,
weighted mean with eps, GRU, residual MLP). The first frame starts from the
learned initial latents. The spatial-broadcast decoder reconstructs each
frame; the losses are the frame MSE and the KL divergence of the kernels
to a prior of variance 0.01 (no penalty on their mean).

Keys follow the reference checkpoints (``encoder.*``, ``slot_attention.*``,
``predictor.*``, ``kernel_dist_layer.*``, ``decoder.*``, ...).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .nn import BroadcastDecoder, PositionEmbed, conv_stack, layer_norm


class SlotAttention(nn.Module):
    def __init__(self, features: int, iters: int, slots: int, size: int,
                 hidden: int, eps: float = 1e-6):
        super().__init__()
        self.iters, self.size, self.eps = iters, size, eps
        self.norm_inputs = layer_norm(features)
        self.project_q = nn.Sequential(layer_norm(size),
                                       nn.Linear(size, size, bias=False))
        self.project_k = nn.Linear(features, size, bias=False)
        self.project_v = nn.Linear(features, size, bias=False)
        self.gru = nn.GRUCell(size, size)
        self.mlp = nn.Sequential(layer_norm(size), nn.Linear(size, hidden),
                                 nn.ReLU(), nn.Linear(hidden, size))

    def kv(self, feats: torch.Tensor):
        x = self.norm_inputs(feats)
        return self.project_k(x), self.project_v(x)

    def forward(self, k: torch.Tensor, v: torch.Tensor,
                slots: torch.Tensor) -> torch.Tensor:
        b, n, d = k.shape
        s = slots.shape[1]
        for _ in range(self.iters):
            q = self.project_q(slots) * self.size ** -0.5
            attn = torch.softmax(k @ q.transpose(1, 2), dim=-1)  # [B, N, S]
            upd = (attn.transpose(1, 2) @ v + self.eps * v.sum(1, keepdim=True)) \
                / (attn.sum(1)[..., None] + self.eps * n)
            slots = self.gru(upd.reshape(b * s, d),
                             slots.reshape(b * s, d)).reshape(b, s, d)
            slots = slots + self.mlp(slots)
        return slots


class StoSAVi(nn.Module):
    def __init__(self, p: dict):
        super().__init__()
        sd, ed, dd = p["slot_dict"], p["enc_dict"], p["dec_dict"]
        pd, ld = p["pred_dict"], p["loss_dict"]
        if pd["pred_type"] != "mlp" or pd["pred_rnn"] or sd["kernel_mlp"]:
            raise NotImplementedError("the reference holds the CLEVRER "
                                      "StoSAVi: MLP predictor, linear kernel head")
        if ed["enc_norm"] or dd["dec_norm"]:
            raise NotImplementedError("norm-free convolutions only")
        res = p["resolution"][0]
        if res != p["resolution"][1] or res == 128:
            raise NotImplementedError("square frames, stride-1 encoder")
        self.S, self.D = sd["num_slots"], sd["slot_size"]
        ch = list(ed["enc_channels"])
        self.init_latents = nn.Parameter(torch.zeros(1, self.S, self.D))
        self.encoder = conv_stack(ch, ed["enc_ks"], last_act=False)
        self.encoder_pos_embedding = PositionEmbed(ch[-1], res, res)
        out = ed["enc_out_channels"]
        self.encoder_out_layer = nn.Sequential(
            layer_norm(ch[-1]), nn.Linear(ch[-1], out), nn.ReLU(),
            nn.Linear(out, out))
        dec = BroadcastDecoder(self.D, dd["dec_channels"],
                               dd["dec_resolution"][0], dd["dec_ks"], res)
        self.decoder = dec.decoder
        self.decoder_pos_embedding = dec.decoder_pos_embedding
        object.__setattr__(self, "dec", dec)
        self.predictor = nn.Module()
        self.predictor.ln = layer_norm(self.D)
        self.predictor.mlp = nn.Sequential(
            nn.Linear(self.D, 2 * self.D), nn.ReLU(),
            nn.Linear(2 * self.D, self.D))
        self.pred_norm_first = pd["pred_norm_first"]
        self.kernel_dist_layer = nn.Sequential(nn.Linear(self.D, 2 * self.D))
        self.slot_attention = SlotAttention(
            out, sd["num_iterations"], self.S, self.D, sd["slot_mlp_size"])
        method, var = ld["kld_method"].split("-")
        if method != "var":
            raise NotImplementedError(ld["kld_method"])
        self.prior_log_var = math.log(float(var))
        self.use_post_recon_loss = ld["use_post_recon_loss"]

    # ------------------------------------------------------------- encode
    def features(self, img: torch.Tensor) -> torch.Tensor:
        """[F, H, W, 3] -> [F, H*W, C]."""
        x = self.encoder(img.permute(0, 3, 1, 2))
        x = self.encoder_pos_embedding(x).flatten(2).transpose(1, 2)
        return self.encoder_out_layer(x)

    def predict(self, slots: torch.Tensor) -> torch.Tensor:
        x = self.predictor.ln(slots)
        res = x if self.pred_norm_first else slots
        return self.predictor.mlp(x) + res

    def encode(self, img: torch.Tensor, generator, prev=None):
        """[B, T, H, W, 3] -> (kernel mean and log-variance [B, T, S, 2D],
        slots [B, T, S, D]); ``prev``: the slots after the previous chunk of
        the same videos (then no frame here is a first frame)."""
        b, t = img.shape[:2]
        feats = self.features(img.reshape(b * t, *img.shape[2:]))
        k, v = self.slot_attention.kv(feats)
        k = k.reshape(b, t, *k.shape[1:])
        v = v.reshape(b, t, *v.shape[1:])
        slots = self.init_latents.expand(b, -1, -1) if prev is None else prev
        dists, outs = [], []
        for i in range(t):
            latents = slots if (prev is None and i == 0) else self.predict(slots)
            dist = self.kernel_dist_layer(latents)
            mu, log_var = dist.chunk(2, -1)
            eps = torch.randn(mu.shape, generator=generator, device=mu.device,
                              dtype=mu.dtype)
            kernels = mu + eps * torch.exp(0.5 * log_var)
            slots = self.slot_attention(k[:, i], v[:, i], kernels)
            dists.append(dist)
            outs.append(slots)
        return torch.stack(dists, 1), torch.stack(outs, 1)

    def encode_video(self, video: torch.Tensor, chunk_len: int, generator):
        """Whole videos [B, T, H, W, 3] in chunks of ``chunk_len`` frames,
        the slots carried from chunk to chunk; a short last chunk is padded
        with its last frame to ``chunk_len`` and the padded frames' slots
        dropped. -> [B, T, S, D]."""
        t = video.shape[1]
        outs, prev = [], None
        for c0 in range(0, t, chunk_len):
            chunk = video[:, c0:c0 + chunk_len]
            pad = chunk_len - chunk.shape[1] if c0 > 0 else 0
            if pad:
                chunk = torch.cat(
                    [chunk, chunk[:, -1:].expand(-1, pad, -1, -1, -1)], 1)
            _, slots = self.encode(chunk, generator, prev)
            prev = slots[:, -1]
            outs.append(slots[:, :slots.shape[1] - pad])
        return torch.cat(outs, 1)

    # -------------------------------------------------------------- losses
    def train_loss(self, batch: dict, generator) -> dict:
        img = batch["img"]
        b, t = img.shape[:2]
        dist, slots = self.encode(img, generator)
        log_var = dist[..., self.D:]
        kld = (0.5 * (self.prior_log_var - log_var)
               + torch.exp(log_var) / (2.0 * math.exp(self.prior_log_var))
               - 0.5)
        losses = {"kld_loss": kld.sum(-1).mean()}
        if self.use_post_recon_loss:
            recon, _ = self.dec(slots.reshape(b * t, self.S, self.D))
            losses["post_recon_loss"] = (
                (recon.reshape(img.shape) - img) ** 2).mean()
        return losses


def build(params: dict) -> StoSAVi:
    return StoSAVi(params)
