"""The Aloe-style CLEVRER VQA transformer (Ding et al. 2020), the port of
``slotformer_tpu/models/aloe.py``.

* Word embeddings (``input_dim - 2`` wide) + a 2-wide question-type tag
  (descriptive rows (0, 1); a multiple-choice row's question part (1, 0),
  its choice part (0, 1)) + a 2-wide text/vision tag; slots get the vision
  tag.
* A zero-initialised CLS token and a learnable positional embedding.
* One transformer encoder (``d_model = (input_dim + 2) * num_heads``) with a
  key-padding mask over the padded question tokens.
* Two answer heads: a multi-class MLP for descriptive questions and a
  binary MLP for each multiple-choice option; CE + BCE losses.

Row-based batching, as in the JAX package: every batch row is ONE
(question[, choice]) pair, and the per-row ``is_cls`` flag selects the
tags and which head's loss applies; question-level multiple-choice scoring
(every choice right) regroups rows by (scene_index, question_id) on the
host (``methods.VQAMethod``, ``cli/test_clevrer_vqa.py``).

Keys are the reference's: ``transformer_model.`` + ``q_embedding``,
``q_in_proj``, ``vision_in_proj``, ``CLS``, ``transformer_encoder.pos_enc``,
``transformer_encoder.transformer_encoder.layers.*``,
``cls_answer_mlp.{0,2}``, ``mc_answer_mlp.{0,2}`` and the fixed tag tokens
(``text_token``, ``vision_token``, ``cls_token``, ``mc_question_token``,
``mc_choice_token``), buffers here, so a reference checkpoint loads as it
is.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import data_mean
from .nn import PosEnc, TransformerEncoder

# the fixed 2-wide tags (requires_grad=False tensors in reference checkpoints)
TAG_TOKENS = {"text_token": (1.0, 0.0), "vision_token": (0.0, 1.0),
              "cls_token": (0.0, 1.0), "mc_question_token": (1.0, 0.0),
              "mc_choice_token": (0.0, 1.0)}


class _PosEncTransformerEncoder(nn.Module):
    """The reference's ``build_transformer_encoder``: a positional table
    (``pos_enc``) added to the input, then the encoder stack."""

    def __init__(self, input_len: int, d_model: int, num_layers: int,
                 num_heads: int, ffn_dim: int, norm_first: bool, pos_enc: str):
        super().__init__()
        self.pos_enc = PosEnc(pos_enc, input_len, d_model)
        self.transformer_encoder = TransformerEncoder(
            d_model, num_layers, num_heads, ffn_dim, norm_first)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.pos_enc is not None:
            x = x + self.pos_enc
        return self.transformer_encoder(x, key_padding_mask=key_padding_mask)


def _mlp(d_in: int, hidden: int, d_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(d_in, hidden), nn.ReLU(), nn.Linear(hidden, d_out))


class CLEVRERTransformerModel(nn.Module):

    def __init__(self, transformer_dict: dict = None, lang_dict: dict = None,
                 vision_dict: dict = None, loss_dict: dict = None):
        super().__init__()
        td, lg, vd = transformer_dict or {}, lang_dict or {}, vision_dict or {}
        if (loss_dict or {}).get("use_mask_obj_loss", False):
            raise ValueError("don't use mask_obj_loss with SAVi slots")
        input_dim = td.get("input_dim", 16)
        num_heads = td.get("num_heads", 10)
        self.d_model = (input_dim + 2) * num_heads  # the Aloe convention
        self.input_len = td.get("input_len", 207) + 1  # + CLS
        self.question_len = lg.get("question_len", 20)
        self.q_embedding = nn.Embedding(lg.get("question_vocab_size", 82),
                                        input_dim - 2)
        self.q_in_proj = nn.Linear(input_dim + 2, self.d_model)
        self.vision_in_proj = nn.Linear(vd.get("vision_dim", 128) + 2,
                                        self.d_model)
        self.CLS = nn.Parameter(torch.zeros(1, 1, self.d_model))
        self.transformer_encoder = _PosEncTransformerEncoder(
            self.input_len, self.d_model, td.get("num_layers", 28), num_heads,
            td.get("ffn_dim", 1024), td.get("norm_first", True),
            td.get("pos_enc", "learnable"))
        cls_mlp = td.get("cls_mlp_size", 128)
        self.cls_answer_mlp = _mlp(self.d_model, cls_mlp,
                                   lg.get("answer_vocab_size", 22))
        self.mc_answer_mlp = _mlp(self.d_model, cls_mlp, 1)
        for name, tag in TAG_TOKENS.items():
            self.register_buffer(name, torch.tensor(tag))

    def forward(self, batch: dict) -> Dict[str, torch.Tensor]:
        """Row-based forward.

        batch: ``video_emb`` [B, T, N, Cv] slots, ``q_tokens`` [B, L] int,
        ``q_pad_mask`` [B, L] (True = padded), ``is_cls`` [B] (a descriptive
        row, else a multiple-choice one). Returns ``cls_answer_logits`` [B, A]
        and ``mc_answer_logits`` [B].
        """
        v = batch["video_emb"]
        B, T, N, Cv = v.shape
        q_tokens = batch["q_tokens"].long()
        L = q_tokens.shape[1]
        is_cls = batch["is_cls"].bool()

        question_part = torch.arange(L, device=v.device) < self.question_len
        mc_tag = torch.where(question_part[:, None], self.mc_question_token,
                             self.mc_choice_token)  # [L, 2]
        qtype_tag = torch.where(is_cls[:, None, None], self.cls_token, mc_tag)
        q_emb = torch.cat([self.q_embedding(q_tokens), qtype_tag,
                           self.text_token.expand(B, L, 2)], dim=-1)
        q_emb = self.q_in_proj(q_emb)  # [B, L, D]

        # the raw slots go through float32 with autocast off: low-precision
        # rounding can swamp small directions of unnormalised slots (JAX
        # runs this projection at Precision.HIGHEST)
        v = v.reshape(B, T * N, Cv).float()
        with torch.autocast(v.device.type, enabled=False):
            v_emb = F.linear(
                torch.cat([v, self.vision_token.expand(B, T * N, 2)], dim=-1),
                self.vision_in_proj.weight.float(),
                self.vision_in_proj.bias.float())
        x = torch.cat([self.CLS.expand(B, 1, self.d_model),
                       v_emb.to(q_emb.dtype), q_emb], dim=1)
        if x.shape[1] != self.input_len:
            raise ValueError(f"input length {x.shape[1]} != configured "
                             f"{self.input_len}")
        pad_mask = torch.cat([torch.zeros(B, 1 + T * N, dtype=torch.bool,
                                          device=v.device),
                              batch["q_pad_mask"].bool()], dim=1)
        cls_emb = self.transformer_encoder(x, key_padding_mask=pad_mask)[:, 0]
        return {"cls_answer_logits": self.cls_answer_mlp(cls_emb),
                "mc_answer_logits": self.mc_answer_mlp(cls_emb)[:, 0]}

    def loss_function(self, batch: dict, out: dict,
                      data_grid=None) -> Dict[str, torch.Tensor]:
        """CE over the descriptive rows, BCE over the multiple-choice rows,
        each a mean over its own rows: over the global batch's rows with a
        ``data_grid`` (each rank divides by the mean count over the data
        group, forward only, so the ranks' mean loss and averaged gradient
        are the global batch's)."""
        is_cls = batch["is_cls"].float()
        n_cls, n_mc = is_cls.sum(), (1.0 - is_cls).sum()
        lo = 1.0
        if data_grid is not None:
            n_cls, n_mc = data_mean(data_grid, n_cls), data_mean(data_grid, n_mc)
            lo /= data_grid.n_data
        label = batch["label"].long()
        ce = F.cross_entropy(out["cls_answer_logits"].float(), label,
                             reduction="none")
        bce = F.binary_cross_entropy_with_logits(
            out["mc_answer_logits"].float(), label.float(), reduction="none")
        return {"cls_answer_loss": (ce * is_cls).sum() / n_cls.clamp(min=lo),
                "mc_answer_loss": (bce * (1.0 - is_cls)).sum() / n_mc.clamp(min=lo)}


class CLEVRERAloe(nn.Module):
    """The trainer's model (reference aloe.py): losses, row-level eval
    accuracies with ``_bs`` companions, and per-row predictions for the
    question-level scoring done on the host."""

    def __init__(self, transformer_dict: dict = None, lang_dict: dict = None,
                 vision_dict: dict = None, loss_dict: dict = None):
        super().__init__()
        self.transformer_model = CLEVRERTransformerModel(
            transformer_dict, lang_dict, vision_dict, loss_dict)
        self.data_grid = None  # parallel.Grid of a data-parallel trainer

    def forward(self, batch: dict) -> Dict[str, torch.Tensor]:
        return self.transformer_model(batch)

    def calc_train_loss(self, batch: dict, out: dict) -> Dict[str, torch.Tensor]:
        return self.transformer_model.loss_function(batch, out)

    def train_loss(self, batch: dict,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The losses of ``batch`` (call in ``train()`` mode: dropout on);
        ``generator`` is the trainer's and goes unused (dropout draws from
        the global RNG)."""
        return self.transformer_model.loss_function(batch, self(batch),
                                                    self.data_grid)

    def eval_step(self, batch: dict):
        """One forward's (``eval_loss``'s dict, ``eval_preds``'s pair)."""
        out = self(batch)
        losses = self.calc_train_loss(batch, out)
        is_cls = batch["is_cls"].float()
        n_cls, n_mc = is_cls.sum(), (1.0 - is_cls).sum()
        label = batch["label"]
        cls_pred = out["cls_answer_logits"].argmax(-1)
        mc_pred = out["mc_answer_logits"] > 0
        cls_right = (cls_pred == label.long()).float()
        mc_right = (mc_pred.float() == label.float()).float()
        losses["descriptive_acc"] = (cls_right * is_cls).sum() / n_cls.clamp(min=1.0)
        losses["choice_acc"] = (mc_right * (1.0 - is_cls)).sum() / n_mc.clamp(min=1.0)
        losses["cls_answer_loss_bs"] = n_cls
        losses["mc_answer_loss_bs"] = n_mc
        losses["descriptive_acc_bs"] = n_cls
        losses["choice_acc_bs"] = n_mc
        return losses, (cls_pred, mc_pred == (label > 0.5))

    def eval_loss(self, batch: dict,
                  generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Losses and row-level accuracies (descriptive rows; each choice
        row), each with a ``<name>_bs`` row count: the trainer weights each
        metric by its own rows (reference clevrer_vqa/method.py:63-112).
        ``generator`` is the trainer's and goes unused."""
        return self.eval_step(batch)[0]

    def eval_preds(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(descriptive answer class [B], whether each row's choice verdict
        is right [B]), for the scoring by question on the host."""
        return self.eval_step(batch)[1]
