"""SlotFormer, the port of ``slotformer_tpu/models/slotformer.py``: rollout,
decode and the training losses, and ``SingleStepSlotFormer``, the PHYRE
variant that rolls out from one frame.

State-dict layout as the reference: ``rollouter.*`` plus the frozen SAVi
decoder's ``decoder.*`` and ``decoder_pos_embedding.*`` at the top level.

The image-reconstruction loss decodes B * rollout_len frames through the
frozen decoder, which is most of a training step's work and memory.
``loss_dict`` picks how, as in the JAX package (precedence: custom > bf16 >
chunked > plain):

  * plain: decode everything, autograd through the decoder;
  * ``dec_chunk_frames`` (default 160, 0 disables): decode in chunks of at
    most that many frames. Each chunk's d(loss)/d(slots) is taken as soon as
    the chunk is decoded (the decoder is frozen and the loss a scalar, so
    nothing else is wanted from its graph) and only that [F, S, D] gradient
    is kept: one chunk's activations are live at a time;
  * ``dec_recon_bf16``: decode everything with the decoder's weights
    (detached) and the slots cast to bfloat16, the error in float32;
  * ``dec_custom_bwd``: ``ops.frozen_decoder_recon_loss``, whose backward
    keeps bool ReLU masks in place of float activations; chunked like the
    second branch, under one global normaliser.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..ops.frozen_decoder_loss import frozen_decoder_recon_loss
from ..parallel.mesh import data_mean
from ..parallel.tp import (ColumnParallelLinear, ParallelMultiheadAttention,
                           RowParallelLinear)
from ..trace import span
from .nn import PosEnc, TransformerEncoder
from .savi import SpatialBroadcastDecoder, _adopt

# modules whose forward runs a collective, which a graph of one process
# cannot hold
_TP_MODULES = (ColumnParallelLinear, RowParallelLinear,
               ParallelMultiheadAttention)


def _pick_chunks(n_frames: int, max_chunk: int) -> int:
    """Smallest chunk count that divides ``n_frames`` with chunks of at most
    ``max_chunk`` frames (1 = no chunking)."""
    if max_chunk <= 0 or n_frames <= max_chunk:
        return 1
    for nc in range(-(-n_frames // max_chunk), n_frames + 1):
        if n_frames % nc == 0:
            return nc
    return 1


class _ChunkedFrozenLoss(torch.autograd.Function):
    """sum_i chunk_loss(i, slots_i) over ``nc`` equal chunks of ``slots``
    [F, S, D], where nothing but ``slots`` wants a gradient. Each chunk's
    gradient is computed right after its forward and its graph dropped, so
    one chunk's activations are live at a time; [F, S, D] is all that is
    saved."""

    @staticmethod
    def forward(ctx, slots, chunk_loss, nc):
        total, grads = slots.new_zeros((), dtype=torch.float32), []
        for i, s in enumerate(slots.chunk(nc)):
            with torch.enable_grad():
                s = s.detach().requires_grad_(True)
                part = chunk_loss(i, s)
                grads.append(torch.autograd.grad(part, s)[0])
            total = total + part.detach().float()
        ctx.save_for_backward(torch.cat(grads))
        return total

    @staticmethod
    def backward(ctx, g):
        (dslots,) = ctx.saved_tensors
        return dslots * g.to(dslots.dtype), None, None


def _sum_chunks(slots: torch.Tensor, chunk_loss: Callable, nc: int):
    """sum_i chunk_loss(i, slots_i); with gradients wanted, through
    ``_ChunkedFrozenLoss``."""
    if torch.is_grad_enabled() and slots.requires_grad:
        return _ChunkedFrozenLoss.apply(slots, chunk_loss, nc)
    return sum(chunk_loss(i, s).float() for i, s in enumerate(slots.chunk(nc)))


class _Graphs:
    """A rollouter's captured rollouts by key, least recently used first,
    at most ``size``. A copy of the module (``copy.deepcopy``, pickling)
    starts with none: the graphs read the original's weights."""

    def __init__(self, size: int = 4):
        self.size = size
        self.by_key = OrderedDict()

    def get(self, key):
        if key in self.by_key:
            self.by_key.move_to_end(key)
        return self.by_key.get(key)

    def put(self, key, graph):
        self.by_key[key] = graph
        while len(self.by_key) > self.size:
            self.by_key.popitem(last=False)
        return graph

    def __reduce__(self):
        return _Graphs, (self.size,)


class SlotRollouter(nn.Module):
    """Sliding-window autoregressive rollout: [B, history_len, N, C] ->
    [B, pred_len, N, C]. The transformer encoder is bidirectional within the
    window, so every step recomputes the whole window.

    The ``pred_len`` steps are one fixed chain of small kernels with nothing
    read back by the host, so where nothing needs the eager loop (no
    autograd, no dropout, a CUDA input outside another capture, no
    tensor-parallel collective) the loop runs as one CUDA graph: captured at
    the first call for a key (input shape, dtype and device, ``pred_len``,
    inference mode and the addresses of the weights, so that weights
    updated in place are read at replay and replaced ones captured anew),
    then replayed from a static input, the output cloned out of it."""

    def __init__(self, num_slots: int, slot_size: int, history_len: int,
                 t_pe: str = "sin", slots_pe: str = "", d_model: int = 128,
                 num_layers: int = 4, num_heads: int = 8, ffn_dim: int = 512,
                 norm_first: bool = True, dropout: float = 0.1):
        super().__init__()
        self.num_slots = num_slots
        self.slot_size = slot_size
        self.history_len = history_len
        self.ctx_len = history_len  # frames of the window
        self.d_model = d_model
        self.in_proj = nn.Linear(slot_size, d_model)
        self.transformer_encoder = TransformerEncoder(
            d_model, num_layers, num_heads, ffn_dim, norm_first, dropout)
        self.out_proj = nn.Linear(d_model, slot_size)
        self.enc_t_pe = PosEnc(t_pe, history_len, d_model)
        self.enc_slots_pe = PosEnc(slots_pe, num_slots, d_model)
        self._graphs = _Graphs()

    def _pos_enc(self) -> torch.Tensor:
        """[1, ctx_len*N, d_model]: temporal PE repeated per slot (+ slot PE
        repeated per step)."""
        pe = torch.zeros(1, self.ctx_len, self.num_slots, self.d_model,
                         device=self.in_proj.weight.device)
        if self.enc_t_pe is not None:
            pe = pe + self.enc_t_pe[:, :, None, :]
        if self.enc_slots_pe is not None:
            pe = pe + self.enc_slots_pe[:, None, :, :]
        return pe.reshape(1, self.ctx_len * self.num_slots, self.d_model)

    def forward(self, x: torch.Tensor, pred_len: int) -> torch.Tensor:
        if x.shape[1] != self.history_len:
            raise ValueError(f"wrong burn-in steps {x.shape[1]}, expected "
                             f"{self.history_len}")
        with span("slotformer.rollouter"):
            if self._graphable(x):
                return self._replay(x, pred_len)
            return self._rollout(x, pred_len)

    def _rollout(self, x: torch.Tensor, pred_len: int) -> torch.Tensor:
        """The loop, run eagerly or captured."""
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

    def _graphable(self, x: torch.Tensor) -> bool:
        return (x.is_cuda and not torch.is_grad_enabled() and not self.training
                and not torch.cuda.is_current_stream_capturing()
                and not any(isinstance(m, _TP_MODULES) for m in self.modules()))

    def _replay(self, x: torch.Tensor, pred_len: int) -> torch.Tensor:
        weights = [*self.parameters(), *self.buffers()]
        key = (tuple(x.shape), x.dtype, x.device, pred_len,
               torch.is_inference_mode_enabled(),
               tuple(w.data_ptr() for w in weights))
        graph, static_in, static_out = (
            self._graphs.get(key)
            or self._graphs.put(key, self._capture(x, pred_len)))
        static_in.copy_(x)
        with span("slotformer.rollouter.graph"):
            graph.replay()
        return static_out.clone()

    def _capture(self, x: torch.Tensor, pred_len: int):
        """(graph, static input, static output) of the loop on ``x``'s
        shape: one eager warm-up on a side stream, then the capture, as
        ``torch.cuda.graphs`` documents it, on ``x``'s card (a replica's
        need not be the current one)."""
        static_in = x.clone(memory_format=torch.contiguous_format)
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(x.device), torch.cuda.stream(side):
            self._rollout(static_in, pred_len)
            with torch.cuda.graph(graph, stream=side):
                static_out = self._rollout(static_in, pred_len)
        torch.cuda.current_stream(x.device).wait_stream(side)
        return graph, static_in, static_out


class SingleStepSlotRollouter(SlotRollouter):
    """Iterative-overlap rollout from one frame (PHYRE; reference
    single_step_slotformer.py:6-90): the context grows [I0] -> [I0, P1] ->
    ... up to ``cond_len`` frames, then slides. As in the JAX package, the
    context is a fixed right-aligned [B, cond_len*N, C] buffer whose unfilled
    left part is hidden from attention by a key-padding mask, so the
    positional encodings sit at the buffer's positions."""

    def __init__(self, num_slots: int, slot_size: int, history_len: int,
                 cond_len: int, **kw):
        if history_len != 1:
            raise ValueError("SingleStepSlotRollouter rolls out from the "
                             "initial frame only (history_len=1)")
        super().__init__(num_slots, slot_size, history_len, **kw)
        self.cond_len = self.ctx_len = cond_len
        self.enc_t_pe = PosEnc(kw.get("t_pe", "sin"), cond_len, self.d_model)

    def forward(self, x: torch.Tensor, pred_len: int) -> torch.Tensor:
        """[B, 1, N, C] -> [B, pred_len, N, C]."""
        if x.shape[1] != 1:
            raise ValueError(f"wrong burn-in steps {x.shape[1]}, expected 1")
        B, _, N, C = x.shape
        L = self.cond_len * N
        with span("slotformer.rollouter"):
            buf = torch.cat([x.new_zeros(B, L - N, C), x.reshape(B, N, C)], 1)
            pe = self._pos_enc().to(buf.dtype)
            tok_pos = torch.arange(L, device=x.device)
            preds = []
            for step in range(pred_len):
                # frames in the buffer so far: the observed one + step
                # predictions
                n_valid = min(1 + step, self.cond_len) * N
                pad = None if n_valid == L else (
                    tok_pos < L - n_valid).expand(B, L)  # True = padded
                h = self.transformer_encoder(self.in_proj(buf) + pe,
                                             key_padding_mask=pad)
                pred = self.out_proj(h[:, -N:])
                preds.append(pred)
                buf = torch.cat([buf[:, N:], pred], dim=1)
            return torch.stack(preds, 1)


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
        self.rollouter = self._make_rollouter(rd)
        ld = loss_dict or {}
        self.eps = eps
        self.rollout_len = ld.get("rollout_len", 6)
        self.use_img_recon_loss = ld.get("use_img_recon_loss", False)
        # how the frozen decoder's image loss is computed: see the module
        # docstring
        self.dec_chunk_frames = int(ld.get("dec_chunk_frames", 160))
        self.dec_recon_bf16 = bool(ld.get("dec_recon_bf16", False))
        self.dec_custom_bwd = bool(ld.get("dec_custom_bwd", False))
        self.data_grid = None  # parallel.Grid of a data-parallel trainer
        if self.dec_custom_bwd and (dec_dict or {}).get("dec_norm", ""):
            raise ValueError("dec_custom_bwd supports norm-free decoders only")

    def _make_rollouter(self, rd: dict) -> nn.Module:
        return SlotRollouter(**rd)

    def _masked_denom(self, count: torch.Tensor) -> torch.Tensor:
        """``count + eps``, the denominator of a ``vid_len``-masked loss.
        Under data parallelism (``data_grid``, set by the trainer) it is the
        global batch's, as the JAX package takes it: each rank divides its
        rows' sum by the mean count over the data group (forward only; the
        count has no gradient), so the ranks' mean loss and averaged
        gradient are the global batch's."""
        if self.data_grid is None:
            return count + self.eps
        return (data_mean(self.data_grid, count)
                + self.eps / self.data_grid.n_data)

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

    # --------------------------------------------------------------- losses
    def _valid(self, batch: dict, B: int, T_ro: int, device):
        """[B, T_ro] bool: rollout frame t is inside its video (``vid_len``
        masking, PHYRE), or None without ``vid_len``."""
        vid_len = batch.get("vid_len")
        if vid_len is None:
            return None
        t = torch.arange(T_ro, device=device) + self.history_len
        return t[None] < vid_len.to(device)[:, None]

    def calc_train_loss(self, batch: dict, out: dict,
                        loss_decay_factor=1.0, training: bool = True) -> dict:
        """Slot MSE (+ image MSE when ``out`` holds ``recon_combined``), with
        the RPIN-style temporal decay and ``vid_len`` masking (reference
        slotformer.py:284-328)."""
        loss_dict = {}
        gt_slots, pred_slots = out["gt_slots"], out["pred_slots"]
        B, T_ro = gt_slots.shape[:2]
        slots_err = (pred_slots - gt_slots) ** 2
        if not training:
            for s in range(min(6, T_ro)):
                loss_dict[f"slot_recon_loss_{s + 1}"] = slots_err[:, s].mean()

        # temporal decay, normalised to sum to T_ro
        w = loss_decay_factor ** torch.arange(
            T_ro, dtype=slots_err.dtype, device=slots_err.device)
        w = w / w.sum() * T_ro
        slots_loss = slots_err * w[None, :, None, None]

        valid = self._valid(batch, B, T_ro, slots_err.device)
        if valid is not None:
            vw = valid[..., None, None].to(slots_loss.dtype)
            loss_dict["slot_recon_loss"] = (slots_loss * vw).sum() / \
                self._masked_denom(vw.sum() * slots_err.shape[-1]
                                   * slots_err.shape[-2])
        else:
            loss_dict["slot_recon_loss"] = slots_loss.mean()

        if self.use_img_recon_loss and "recon_combined" in out:
            gt_img = batch["img"][:, self.history_len:]
            img_err = (out["recon_combined"] - gt_img) ** 2
            if valid is not None:
                iw = valid[..., None, None, None].to(img_err.dtype)
                loss_dict["img_recon_loss"] = (img_err * iw).sum() / \
                    self._masked_denom(iw.sum() * img_err[0, 0].numel())
            else:
                loss_dict["img_recon_loss"] = img_err.mean()
        return loss_dict

    def _flat_img_loss_inputs(self, batch: dict, pred_slots: torch.Tensor):
        """(slots [F, S, D], gt [F, H, W, C], frame weights [F] float32 or
        None without ``vid_len``) over the F = B * T_ro rollout frames."""
        B, T_ro = pred_slots.shape[:2]
        gt_img = batch["img"][:, self.history_len:]
        flat_slots = pred_slots.reshape(B * T_ro, self.num_slots, self.slot_size)
        flat_img = gt_img.reshape(B * T_ro, *gt_img.shape[2:])
        valid = self._valid(batch, B, T_ro, pred_slots.device)
        w = None if valid is None else valid.reshape(-1).float()
        return flat_slots, flat_img, w

    def _chunked_img_recon_loss(self, batch: dict, pred_slots: torch.Tensor,
                                nc: int) -> torch.Tensor:
        """Image MSE through the frozen decoder, ``nc`` chunks one after the
        other (see ``dec_chunk_frames``); the value of the unchunked
        ``calc_train_loss``, ``vid_len`` masking included."""
        flat_slots, flat_img, w = self._flat_img_loss_inputs(batch, pred_slots)
        n = flat_slots.shape[0] // nc

        def chunk_sse(i, s):
            recon = self.decode(s)[0]
            err = ((recon - flat_img[i * n:(i + 1) * n]) ** 2).sum(dim=(1, 2, 3))
            if w is not None:
                err = err * w[i * n:(i + 1) * n].to(err.dtype)
            return err.sum()

        sse = _sum_chunks(flat_slots, chunk_sse, nc)
        if w is not None:
            return sse / self._masked_denom(w.sum() * flat_img[0].numel())
        return sse / flat_img.numel()

    def _bf16_img_recon_loss(self, batch: dict,
                             pred_slots: torch.Tensor) -> torch.Tensor:
        """Whole-batch image MSE through the frozen decoder with its weights
        (detached here, so no weight gradient ever sees the reduced
        precision) and the slots cast to bfloat16; the error and its sum in
        float32. The gradient still reaches the rollouter through the
        bfloat16 decode."""
        flat_slots, flat_img, w = self._flat_img_loss_inputs(batch, pred_slots)
        dec = self.spatial_decoder
        p16 = {k: (v.detach().to(torch.bfloat16) if v.is_floating_point()
                   else v) for k, v in dec.state_dict(keep_vars=True).items()}
        recon = torch.func.functional_call(
            dec, p16, (flat_slots.to(torch.bfloat16),))[0]
        err = (recon.float() - flat_img) ** 2
        if w is None:
            return err.mean()
        return (err.sum(dim=(1, 2, 3)) * w).sum() / self._masked_denom(
            w.sum() * flat_img[0].numel())

    def _custom_bwd_img_recon_loss(self, batch: dict,
                                   pred_slots: torch.Tensor) -> torch.Tensor:
        """Image MSE through ``ops.frozen_decoder_recon_loss`` (bool ReLU
        masks saved, exact gradients). Composes with ``dec_chunk_frames``:
        the chunks' losses are summed under one global normaliser."""
        flat_slots, flat_img, w = self._flat_img_loss_inputs(batch, pred_slots)
        n_frames = flat_slots.shape[0]
        if w is not None:
            denom = self._masked_denom(w.sum() * flat_img[0].numel())
        else:
            w = flat_img.new_ones(n_frames, dtype=torch.float32)
            denom = float(flat_img.numel())
        dec = self.spatial_decoder
        nc = _pick_chunks(n_frames, self.dec_chunk_frames)
        if nc <= 1:
            return frozen_decoder_recon_loss(dec, flat_slots, flat_img, w,
                                             denom, self.num_slots)
        n = n_frames // nc
        return _sum_chunks(
            flat_slots,
            lambda i, s: frozen_decoder_recon_loss(
                dec, s, flat_img[i * n:(i + 1) * n], w[i * n:(i + 1) * n],
                denom, self.num_slots),
            nc)

    def train_loss(self, batch: dict, loss_decay_factor=1.0,
                   generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` (call in ``train()`` mode: the
        rollouter's dropout then draws from torch's global RNG;
        ``generator`` is the trainer's and is not used)."""
        if not self.use_img_recon_loss:
            branch = "plain"
        elif self.dec_custom_bwd:
            branch = "custom"
        elif self.dec_recon_bf16:
            branch = "bf16"
        else:
            nc = _pick_chunks(batch["slots"].shape[0] * self.rollout_len,
                              self.dec_chunk_frames)
            branch = "plain" if nc == 1 else "chunked"
        if branch == "plain":
            return self.calc_train_loss(
                batch, self(batch), loss_decay_factor=loss_decay_factor)
        # roll out without decoding: the slot loss from calc_train_loss, the
        # image loss from the branch
        slots = batch["slots"]
        pred_slots = self.rollouter(slots[:, :self.history_len], self.rollout_len)
        out = {"gt_slots": slots[:, self.history_len:], "pred_slots": pred_slots}
        loss_dict = self.calc_train_loss(
            batch, out, loss_decay_factor=loss_decay_factor)
        # where the loss goes in chunks, the decode's input gradient is
        # taken here too, chunk by chunk
        with span("slotformer.image_loss"):
            if branch == "custom":
                img_loss = self._custom_bwd_img_recon_loss(batch, pred_slots)
            elif branch == "bf16":
                img_loss = self._bf16_img_recon_loss(batch, pred_slots)
            else:
                img_loss = self._chunked_img_recon_loss(batch, pred_slots, nc)
        loss_dict["img_recon_loss"] = img_loss
        return loss_dict

    def eval_loss(self, batch: dict,
                  generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` plus the per-step slot losses
        ``slot_recon_loss_1..6`` (call in ``eval()`` mode)."""
        return self.calc_train_loss(batch, self(batch), training=False)


class SingleStepSlotFormer(SlotFormer):
    """The PHYRE variant: one observed frame, iterative-overlap rollout
    (reference single_step_slotformer.py:93-129). The task-success
    classifier is the separate ``PHYREReadout``."""

    def _make_rollouter(self, rd: dict) -> nn.Module:
        return SingleStepSlotRollouter(**rd)
