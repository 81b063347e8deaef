"""STEVE (a video slot encoder with a transformer token decoder), plain
float32.

The published model (Singh, Wu and Ahn, NeurIPS 2022, as pairlab/SlotFormer
ships it for Physion): a CNN encoder over each frame, a coordinate
embedding and an LN-MLP head give N = h * w features; the first frame's
slot attention starts from the learned initial latents, every later one
from the predictor's output over the previous frame's slots (pre-LN
transformer layers over the slot set, then one LSTM step over the B * S
slot tokens and a projection back); ``num_iterations`` rounds of slot
attention (softmax over the slots, weighted mean with eps, GRU, residual
MLP), whose last round's attention are the masks. The frozen dVAE turns
frames into token ids; here the loader gives them (``token_id``), as the
published Physion recipe does, so the dVAE is held for its weights alone.
The SLATE token decoder predicts each frame's ids from its slots under
teacher forcing: the BOS id ``vocab_size`` and the ids but the last,
embedded, plus a learned position encoding, dropout; blocks of causal
self-attention, cross-attention to the projected slots and a ReLU FFN, each
pre-LN (block 0 replaces its input itself by the LayerNorm's output, the
SLATE ``is_first`` quirk); a final LayerNorm and a bias-free head. The
attention is written out: scaled logits, the causal mask, softmax,
dropout on the weights, the weighted sum, the output projection and its
dropout. The loss is the cross-entropy over every position.

Departures from the published description, all of them the program's
numerics, which the reference follows: LayerNorm and GroupNorm eps 1e-6
(torch's default is 1e-5); the stride-2 first convolution of 128-wide
frames pads as XLA's ``SAME`` (one row and column before, two after; the
published model pads two on each side); the slot-attention weights'
softmax is over the slots of the last round, as kernel K1 returns it. The
self-attention of the token decoder runs in blocks of frames, each block's
weights recomputed in the backward pass (the same arithmetic in less
memory: 288 frames x 4 heads x 1024^2 weights are 4.8 GB a layer). It
computes every query-key pair, the masked ones too; ``masked_flops`` gives
the work on those, which a step's count leaves out.

Keys follow the reference checkpoints: ``init_latents``, ``encoder.*``,
``encoder_pos_embedding.*``, ``encoder_out_layer.*``, ``slot_attention.*``,
``predictor.*`` (``base_predictor.transformer_encoder.layers.*``,
``rnn.*_l0``, ``out_projector``), ``dvae.*`` and ``trans_decoder.*``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .nn import PositionEmbed, layer_norm

GN_EPS = 1e-6
# weights of the decoder's self-attention held at once in a block (floats)
ATTN_BLOCK_FLOATS = 2 ** 28


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA's ``SAME`` padding of an NCHW map for a k x k, stride-s window."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class Encoder(nn.Sequential):
    """Conv2d (k, stride 2 for the first layer of 128-wide frames, else 1)
    + ReLU but after the last; keys ``<i>.0.*``."""

    def __init__(self, channels, ks: int, stride0: int):
        layers = []
        for i in range(len(channels) - 1):
            parts = [nn.Conv2d(channels[i], channels[i + 1], ks,
                               stride=stride0 if i == 0 else 1)]
            if i < len(channels) - 2:
                parts.append(nn.ReLU())
            layers.append(nn.Sequential(*parts))
        super().__init__(*layers)
        self.ks = ks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            conv = layer[0]
            x = conv(_same_pad(x, self.ks, conv.stride[0]))
            if len(layer) > 1:
                x = layer[1](x)
        return x


def gru(x: torch.Tensor, h: torch.Tensor, cell: nn.GRUCell) -> torch.Tensor:
    """One GRU step on ``cell``'s weights (gates r, z, n)."""
    gi = F.linear(x, cell.weight_ih, cell.bias_ih).chunk(3, -1)
    gh = F.linear(h, cell.weight_hh, cell.bias_hh).chunk(3, -1)
    r = torch.sigmoid(gi[0] + gh[0])
    z = torch.sigmoid(gi[1] + gh[1])
    n = torch.tanh(gi[2] + r * gh[2])
    return (1.0 - z) * n + z * h


class SlotAttention(nn.Module):
    def __init__(self, features: int, iters: int, size: int, hidden: int,
                 eps: float = 1e-6):
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

    def forward(self, k: torch.Tensor, v: torch.Tensor, slots: torch.Tensor):
        """-> (slots [B, S, D], the last round's attention [B, N, S])."""
        b, n, d = k.shape
        s = slots.shape[1]
        for _ in range(self.iters):
            q = self.project_q(slots) * self.size ** -0.5
            attn = torch.softmax(k @ q.transpose(1, 2), dim=-1)  # [B, N, S]
            upd = (attn.transpose(1, 2) @ v + self.eps * v.sum(1, keepdim=True)) \
                / (attn.sum(1)[..., None] + self.eps * n)
            slots = gru(upd.reshape(b * s, d), slots.reshape(b * s, d),
                        self.gru).reshape(b, s, d)
            slots = slots + self.mlp(slots)
        return slots, attn


class PredictorLayer(nn.Module):
    """Pre-LN transformer layer over the slots, dropout 0.1, the attention
    written out (keys as ``nn.TransformerEncoderLayer``)."""

    def __init__(self, d: int, heads: int, ffn: int, dropout: float = 0.1):
        super().__init__()
        self.self_attn = nn.MultiheadAttention(d, heads, batch_first=True)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm1 = layer_norm(d)
        self.norm2 = layer_norm(d)
        self.attn_dropout = nn.Dropout(dropout)
        self.dropout = nn.Dropout(dropout)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        self.heads = heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.self_attn
        b, n, d = x.shape
        hd = d // self.heads
        q, k, v = F.linear(self.norm1(x), a.in_proj_weight,
                           a.in_proj_bias).chunk(3, -1)
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2)
                   for t in (q, k, v))
        w = self.attn_dropout(torch.softmax(
            q @ k.transpose(-1, -2) / math.sqrt(hd), -1))
        x = x + self.dropout1(a.out_proj((w @ v).transpose(1, 2).reshape(b, n, d)))
        h = self.linear2(self.dropout(F.relu(self.linear1(self.norm2(x)))))
        return x + self.dropout2(h)


class Predictor(nn.Module):
    """Transformer layers over the slot set, then one LSTM step over the
    B * S slot tokens (gates i, f, g, o) and a projection back."""

    def __init__(self, d: int, hidden: int, pd: dict):
        super().__init__()
        self.base_predictor = nn.Module()
        self.base_predictor.transformer_encoder = nn.Module()
        self.base_predictor.transformer_encoder.layers = nn.ModuleList(
            PredictorLayer(d, pd["pred_num_heads"], pd["pred_ffn_dim"])
            for _ in range(pd["pred_num_layers"]))
        self.rnn = nn.LSTM(d, hidden)
        self.out_projector = nn.Linear(hidden, d)
        self.hidden = hidden

    def forward(self, x: torch.Tensor, state):
        for layer in self.base_predictor.transformer_encoder.layers:
            x = layer(x)
        shape = x.shape
        c, h = state
        r = self.rnn
        gates = (F.linear(x.reshape(-1, shape[-1]), r.weight_ih_l0, r.bias_ih_l0)
                 + F.linear(h, r.weight_hh_l0, r.bias_hh_l0))
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return self.out_projector(h).reshape(shape), (c, h)


class GNConv(nn.Module):
    """Bias-free conv ``m`` + GroupNorm(1) with affine ``weight``, ``bias``
    + ReLU: the dVAE's block."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1):
        super().__init__()
        self.m = nn.Conv2d(cin, cout, k, stride, k // 2 if stride == 1 else 0,
                           bias=False)
        self.weight = nn.Parameter(torch.ones(cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(F.group_norm(self.m(x), 1, self.weight, self.bias,
                                   eps=GN_EPS))


class DVAE(nn.Module):
    """The dVAE's modules (frozen; the tokens come from the loader)."""

    def __init__(self, vocab: int):
        super().__init__()
        self.encoder = nn.Sequential(
            GNConv(3, 64, 4, 4), *[GNConv(64, 64) for _ in range(6)],
            nn.Conv2d(64, vocab, 1))
        self.decoder = nn.Sequential(
            GNConv(vocab, 64), GNConv(64, 64, 3), GNConv(64, 64),
            GNConv(64, 64), GNConv(64, 256), nn.PixelShuffle(2),
            GNConv(64, 64, 3), GNConv(64, 64), GNConv(64, 64), GNConv(64, 256),
            nn.PixelShuffle(2), nn.Conv2d(64, 3, 1))


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask,
            drop: nn.Dropout) -> torch.Tensor:
    w = q @ k.transpose(-1, -2)
    if mask is not None:
        w = w.masked_fill(mask, float("-inf"))
    return drop(torch.softmax(w, -1)) @ v


class Attention(nn.Module):
    """SLATE's bias-free multi-head attention, queries scaled by
    ``head_dim ** -0.5``, dropout on the weights and on the output."""

    def __init__(self, d: int, heads: int, dropout: float = 0.1):
        super().__init__()
        self.heads = heads
        self.proj_q = nn.Linear(d, d, bias=False)
        self.proj_k = nn.Linear(d, d, bias=False)
        self.proj_v = nn.Linear(d, d, bias=False)
        self.proj_o = nn.Linear(d, d, bias=False)
        self.attn_dropout = nn.Dropout(dropout)
        self.output_dropout = nn.Dropout(dropout)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        return x.reshape(b, t, self.heads, d // self.heads).transpose(1, 2)

    def forward(self, x: torch.Tensor, kv: torch.Tensor, mask=None):
        q = self._split(self.proj_q(x))
        q = q * q.shape[-1] ** -0.5
        k, v = self._split(self.proj_k(kv)), self._split(self.proj_v(kv))
        b, h, t, _ = q.shape
        rows = max(1, ATTN_BLOCK_FLOATS // (h * t * k.shape[2]))
        if q.is_meta or rows >= b or not torch.is_grad_enabled():
            out = _attend(q, k, v, mask, self.attn_dropout)
        else:
            # blocks of frames, each one's weights recomputed in the
            # backward pass from the same dropout draws
            out = torch.cat([
                checkpoint(_attend, q[i:i + rows], k[i:i + rows],
                           v[i:i + rows], mask, self.attn_dropout,
                           use_reentrant=False)
                for i in range(0, b, rows)])
        out = out.transpose(1, 2).reshape(b, t, -1)
        return self.output_dropout(self.proj_o(out))


class DecoderBlock(nn.Module):
    def __init__(self, length: int, d: int, heads: int, is_first: bool,
                 dropout: float = 0.1):
        super().__init__()
        self.is_first = is_first
        self.self_attn_layer_norm = layer_norm(d)
        self.self_attn = Attention(d, heads, dropout)
        self.register_buffer("self_attn_mask", torch.triu(
            torch.ones(length, length, dtype=torch.bool), diagonal=1))
        self.encoder_decoder_attn_layer_norm = layer_norm(d)
        self.encoder_decoder_attn = Attention(d, heads, dropout)
        self.ffn_layer_norm = layer_norm(d)
        self.ffn = nn.Sequential(nn.Linear(d, 4 * d), nn.ReLU(),
                                 nn.Linear(4 * d, d), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        h = self.self_attn_layer_norm(x)
        if self.is_first:
            x = h
        x = x + self.self_attn(h, h, self.self_attn_mask[:t, :t])
        x = x + self.encoder_decoder_attn(
            self.encoder_decoder_attn_layer_norm(x), enc)
        return x + self.ffn(self.ffn_layer_norm(x))


class TokenDecoder(nn.Module):
    def __init__(self, vocab: int, d: int, heads: int, layers: int,
                 length: int, dropout: float = 0.1):
        super().__init__()
        self.vocab = vocab
        self.in_proj = nn.Linear(d, d)
        self.tok_emb = nn.Embedding(vocab + 1, d)
        self.pos_emb = nn.Module()
        self.pos_emb.pe = nn.Parameter(torch.zeros(1, length, d))
        self.pos_drop = nn.Dropout(dropout)
        self.tf_dec = nn.Module()
        self.tf_dec.blocks = nn.ModuleList(
            DecoderBlock(length, d, heads, i == 0, dropout)
            for i in range(layers))
        self.tf_dec.layer_norm = layer_norm(d)
        self.head = nn.Linear(d, vocab, bias=False)

    def forward(self, slots: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """slots [F, S, D], ids [F, P] -> logits [F, P, vocab] of every
        position, from the BOS id and the ids but the last."""
        enc = self.in_proj(slots)
        bos = ids.new_full((ids.shape[0], 1), self.vocab)
        x = self.tok_emb(torch.cat([bos, ids[:, :-1]], 1))
        x = self.pos_drop(x + self.pos_emb.pe[:, :x.shape[1]])
        for blk in self.tf_dec.blocks:
            x = blk(x, enc)
        return self.head(self.tf_dec.layer_norm(x))


class STEVE(nn.Module):
    def __init__(self, p: dict):
        super().__init__()
        sd, ed, dv = p["slot_dict"], p["enc_dict"], p["dvae_dict"]
        dd, pd = p["dec_dict"], p["pred_dict"]
        if (pd["pred_type"] != "transformer" or not pd["pred_rnn"]
                or not pd["pred_norm_first"] or pd["pred_sg_every"] is not None):
            raise NotImplementedError("the reference holds the Physion STEVE: "
                                      "pre-LN transformer predictor with an LSTM")
        if ed["enc_norm"] or p["loss_dict"]["use_img_recon_loss"]:
            raise NotImplementedError("norm-free encoder, token loss only")
        res = p["resolution"][0]
        if res != p["resolution"][1]:
            raise NotImplementedError("square frames")
        stride0 = 2 if res == 128 else 1
        self.S, self.D = sd["num_slots"], sd["slot_size"]
        if dd["dec_d_model"] != self.D:
            raise NotImplementedError("the decoder's width is the slots'")
        ch = list(ed["enc_channels"])
        self.init_latents = nn.Parameter(torch.zeros(1, self.S, self.D))
        self.encoder = Encoder(ch, ed["enc_ks"], stride0)
        self.encoder_pos_embedding = PositionEmbed(ch[-1], res // stride0,
                                                   res // stride0)
        out = ed["enc_out_channels"]
        self.encoder_out_layer = nn.Sequential(
            layer_norm(ch[-1]), nn.Linear(ch[-1], out), nn.ReLU(),
            nn.Linear(out, out))
        self.predictor = Predictor(self.D, sd["slot_mlp_size"], pd)
        self.slot_attention = SlotAttention(
            out, sd["num_iterations"], self.D, sd["slot_mlp_size"])
        vocab = dv["vocab_size"]
        self.patches = (res // dv["down_factor"]) ** 2
        self.dvae = DVAE(vocab)
        self.trans_decoder = TokenDecoder(vocab, self.D, dd["dec_num_heads"],
                                          dd["dec_num_layers"], self.patches)

    def features(self, img: torch.Tensor) -> torch.Tensor:
        """[F, H, W, 3] -> [F, h*w, C]."""
        x = self.encoder(img.permute(0, 3, 1, 2))
        x = self.encoder_pos_embedding(x).flatten(2).transpose(1, 2)
        return self.encoder_out_layer(x)

    def encode(self, img: torch.Tensor):
        """[B, T, H, W, 3] -> (slots [B, T, S, D], masks [B, T, S, N])."""
        b, t = img.shape[:2]
        k, v = self.slot_attention.kv(
            self.features(img.reshape(b * t, *img.shape[2:])))
        k = k.reshape(b, t, *k.shape[1:])
        v = v.reshape(b, t, *v.shape[1:])
        slots = self.init_latents.expand(b, -1, -1)
        zeros = slots.new_zeros(b * self.S, self.predictor.hidden)
        state = (zeros, zeros)
        outs, masks = [], []
        for i in range(t):
            if i > 0:
                slots, state = self.predictor(slots, state)
            slots, attn = self.slot_attention(k[:, i], v[:, i], slots)
            outs.append(slots)
            masks.append(attn.transpose(1, 2))
        return torch.stack(outs, 1), torch.stack(masks, 1)

    def train_loss(self, batch: dict, generator=None) -> dict:
        img = batch["img"]
        b, t = img.shape[:2]
        slots, _ = self.encode(img)
        ids = batch["token_id"].reshape(b * t, self.patches).long()
        logits = self.trans_decoder(slots.reshape(b * t, self.S, self.D), ids)
        return {"token_recon_loss": F.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), ids.reshape(-1))}


def build(params: dict) -> STEVE:
    return STEVE(params)


def masked_flops(params: dict, batch: dict) -> int:
    """The FLOPs of a training step, as ``FlopCounterMode`` counts this
    model's ``train_loss`` and its gradient, that fall on the n (n - 1) / 2
    masked query-key pairs of the token decoder's causal self-attention
    (n tokens a frame): a causal kernel skips them. Per layer, frame and
    pair, the logit and the weighted sum take 2 d FLOPs each forward, and
    the two input gradients of each twice that again."""
    dd = params["dec_dict"]
    frames = batch["img"].shape[0] * batch["img"].shape[1]
    n = (params["resolution"][0] // params["dvae_dict"]["down_factor"]) ** 2
    pairs = n * (n - 1) // 2
    return 3 * 2 * 2 * dd["dec_num_layers"] * frames * dd["dec_d_model"] * pairs
