"""The STEVE / SLATE Transformer decoder over dVAE tokens, the port of
``slotformer_tpu/models/steve_transformer.py``.

Bias-free multi-head attention with the queries scaled by
``head_dim ** -0.5``, a learned positional encoding (``pos_emb.pe``),
decoder blocks with causal self-attention, cross-attention to the slots and
a ReLU FFN, the SLATE ``is_first`` quirk (block 0 replaces x itself by
LN(x)), a final LayerNorm and a bias-free vocabulary head; the BOS token is
id ``vocab_size``.

State-dict layout as the reference: ``in_proj``, ``tok_emb``, ``pos_emb.pe``,
``tf_dec.blocks.{i}.{self_attn,encoder_decoder_attn}.proj_{q,k,v,o}``,
``tf_dec.blocks.{i}.{self_attn,encoder_decoder_attn,ffn}_layer_norm``,
``tf_dec.blocks.{i}.ffn.{0,2}``, ``tf_dec.blocks.{i}.self_attn_mask`` (the
reference's causal-mask buffer, kept so its checkpoints load as they are),
``tf_dec.layer_norm``, ``head``. LayerNorms use eps 1e-6, as the JAX package.

``generate`` decodes with a key/value cache per block, written one position
a step, and the cross-attention keys and values computed once per call: one
decoder pass per token, not the reference's full re-forward of the prefix.
Sampling draws from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .nn import LayerNorm


class STEVEMultiHeadAttention(nn.Module):
    """Bias-free MHA (``proj_{q,k,v,o}``); queries scaled by
    ``head_dim ** -0.5``."""

    def __init__(self, d_model: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads = num_heads
        self.dropout = dropout
        self.proj_q = nn.Linear(d_model, d_model, bias=False)
        self.proj_k = nn.Linear(d_model, d_model, bias=False)
        self.proj_v = nn.Linear(d_model, d_model, bias=False)
        self.proj_o = nn.Linear(d_model, d_model, bias=False)
        self.out_drop = nn.Dropout(dropout)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> [B, heads, T, head_dim]."""
        B, T, D = x.shape
        return x.reshape(B, T, self.num_heads, D // self.num_heads).transpose(1, 2)

    def kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Head-split keys and values of ``x``, for caches and for
        cross-attention computed once."""
        return self.split(self.proj_k(x)), self.split(self.proj_v(x))

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = False) -> torch.Tensor:
        """Head-split ``q`` [B, h, Tq, hd] over ``k``/``v`` [B, h, Tk, hd]
        -> the projected output [B, Tq, D]."""
        out = F.scaled_dot_product_attention(
            q, k, v, is_causal=causal,
            dropout_p=self.dropout if self.training else 0.0)
        B, h, T, hd = out.shape
        return self.out_drop(self.proj_o(out.transpose(1, 2).reshape(B, T, h * hd)))

    def forward(self, q: torch.Tensor, kv: torch.Tensor,
                causal: bool = False) -> torch.Tensor:
        return self.attend(self.split(self.proj_q(q)), *self.kv(kv), causal)


class LearnedPositionalEncoding(nn.Module):
    """``pe`` [1, max_len, D] (truncated normal init) + dropout."""

    def __init__(self, max_len: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.pe = nn.Parameter(nn.init.trunc_normal_(
            torch.empty(1, max_len, d_model)))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        return self.dropout(x + self.pe[:, offset:offset + x.shape[1]])


class TransformerDecoderBlock(nn.Module):
    """Causal self-attention + cross-attention to the slots + FFN, each
    pre-LN, with block 0's ``is_first`` quirk."""

    def __init__(self, max_len: int, d_model: int, num_heads: int,
                 dropout: float = 0.0, is_first: bool = False):
        super().__init__()
        self.is_first = is_first
        self.self_attn_layer_norm = LayerNorm(d_model)
        self.self_attn = STEVEMultiHeadAttention(d_model, num_heads, dropout)
        self.register_buffer("self_attn_mask", torch.triu(
            torch.ones(max_len, max_len, dtype=torch.bool), diagonal=1))
        self.encoder_decoder_attn_layer_norm = LayerNorm(d_model)
        self.encoder_decoder_attn = STEVEMultiHeadAttention(
            d_model, num_heads, dropout)
        self.ffn_layer_norm = LayerNorm(d_model)
        self.ffn = nn.Sequential(
            nn.Linear(d_model, 4 * d_model), nn.ReLU(),
            nn.Linear(4 * d_model, d_model), nn.Dropout(dropout))

    def _self_in(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(residual stream, self-attention input): block 0 replaces x itself
        by LN(x)."""
        h = self.self_attn_layer_norm(x)
        return (h, h) if self.is_first else (x, h)

    def _rest(self, x: torch.Tensor, cross_k: torch.Tensor,
              cross_v: torch.Tensor) -> torch.Tensor:
        attn = self.encoder_decoder_attn
        h = self.encoder_decoder_attn_layer_norm(x)
        x = x + attn.attend(attn.split(attn.proj_q(h)), cross_k, cross_v)
        return x + self.ffn(self.ffn_layer_norm(x))

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        x, h = self._self_in(x)
        x = x + self.self_attn(h, h, causal=True)
        return self._rest(x, *self.encoder_decoder_attn.kv(enc_out))

    def step(self, x_t: torch.Tensor, cache: Tuple[torch.Tensor, torch.Tensor],
             pos: int, cross_k: torch.Tensor, cross_v: torch.Tensor
             ) -> torch.Tensor:
        """One decode step: ``x_t`` [B, 1, D] at position ``pos``; writes
        its key and value into ``cache`` ([B, heads, L, head_dim] each) and
        attends to positions 0..pos."""
        x_t, h = self._self_in(x_t)
        k_cache, v_cache = cache
        k_new, v_new = self.self_attn.kv(h)
        k_cache[:, :, pos:pos + 1] = k_new
        v_cache[:, :, pos:pos + 1] = v_new
        q = self.self_attn.split(self.self_attn.proj_q(h))
        x_t = x_t + self.self_attn.attend(q, k_cache[:, :, :pos + 1],
                                          v_cache[:, :, :pos + 1])
        return self._rest(x_t, cross_k, cross_v)


class TransformerDecoder(nn.Module):
    """``blocks`` + the final ``layer_norm`` (the reference's ``tf_dec``)."""

    def __init__(self, num_blocks: int, max_len: int, d_model: int,
                 num_heads: int, dropout: float = 0.1):
        super().__init__()
        self.blocks = nn.ModuleList([
            TransformerDecoderBlock(max_len, d_model, num_heads, dropout,
                                    is_first=(i == 0))
            for i in range(num_blocks)])
        self.layer_norm = LayerNorm(d_model)


class STEVETransformerDecoder(nn.Module):
    """Slot-conditioned causal token decoder. ``max_len`` is
    ``num_patches - 1``: the BOS token takes one more position."""

    def __init__(self, vocab_size: int, d_model: int, n_head: int,
                 max_len: int, num_slots: int, num_layers: int,
                 dropout: float = 0.1):
        super().__init__()
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.num_slots = num_slots
        self.in_proj = nn.Linear(d_model, d_model)
        self.tok_emb = nn.Embedding(vocab_size + 1, d_model)
        self.pos_emb = LearnedPositionalEncoding(max_len + 1, d_model, dropout)
        self.tf_dec = TransformerDecoder(num_layers, max_len + 1, d_model,
                                         n_head, dropout)
        self.head = nn.Linear(d_model, vocab_size, bias=False)

    def forward(self, slots: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Teacher forcing: slots [B, N, C] and token ids ``idx`` [B, t]
        (t <= max_len, the last target token left out) -> logits
        [B, 1 + t, vocab]."""
        if slots.shape[1] != self.num_slots:
            raise ValueError(f"{slots.shape[1]} slots, the decoder takes "
                             f"{self.num_slots}")
        B, T = idx.shape
        if T > self.max_len:
            raise ValueError(f"{T} tokens, the decoder takes {self.max_len}")
        enc = self.in_proj(slots)
        bos = idx.new_full((B, 1), self.vocab_size)
        x = self.pos_emb(self.tok_emb(torch.cat([bos, idx], 1)))
        for blk in self.tf_dec.blocks:
            x = blk(x, enc)
        return self.head(self.tf_dec.layer_norm(x))

    def generate(self, slots: torch.Tensor, steps: int, sample: bool = False,
                 temperature: float = 1.0,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Autoregressive decode from the BOS token: slots [B, N, C] ->
        (ids [B, steps] int64, logits [B, steps, vocab]); greedy, or sampled
        at ``temperature`` from ``generator``."""
        if steps - 1 > self.max_len:
            raise ValueError(f"{steps} steps, the decoder takes "
                             f"{self.max_len + 1}")
        blocks = self.tf_dec.blocks
        enc = self.in_proj(slots)
        cross = [blk.encoder_decoder_attn.kv(enc) for blk in blocks]
        B, heads, _, hd = cross[0][0].shape
        caches = [(enc.new_empty(B, heads, steps, hd),
                   enc.new_empty(B, heads, steps, hd)) for _ in blocks]
        tok = torch.full((B,), self.vocab_size, dtype=torch.long,
                         device=slots.device)
        ids: List[torch.Tensor] = []
        logits: List[torch.Tensor] = []
        for pos in range(steps):
            x = self.pos_emb(self.tok_emb(tok)[:, None], offset=pos)
            for blk, cache, (ck, cv) in zip(blocks, caches, cross):
                x = blk.step(x, cache, pos, ck, cv)
            step_logits = self.head(self.tf_dec.layer_norm(x))[:, 0]
            if sample:
                probs = torch.softmax(step_logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = step_logits.argmax(-1)
            ids.append(tok)
            logits.append(step_logits)
        return torch.stack(ids, 1), torch.stack(logits, 1)
