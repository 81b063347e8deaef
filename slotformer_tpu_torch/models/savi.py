"""StoSAVi, the port of ``slotformer_tpu/models/savi.py``.

Layouts: ``img`` is NHWC ``[B, T, H, W, 3]`` in [-1, 1], as in the JAX
package; the CNNs run in NCHW inside.

State-dict layout: the reference keeps the encoder's, the temporal cell's
and the decoder's parts at the top level (``encoder.*``,
``encoder_pos_embedding.*``, ``encoder_out_layer.*``, ``slot_attention.*``,
``predictor.*``, ``kernel_dist_layer.*``, ``decoder.*``,
``decoder_pos_embedding.*``, ``init_latents``). ``FrameEncoder``,
``SAViCell`` and ``SpatialBroadcastDecoder`` are modules of their own here,
as in the JAX package, and ``StoSAVi`` registers their parts under those
top-level names (see ``_adopt``). The reference's vestigial
``prior_slot_layer.*`` keys are skipped on load.

The temporal recurrence is a Python loop over frames. Kernel-sampling noise
comes from ``sample_eps`` ([B, T, S, D], the parity-test hook) or else from
the ``torch.Generator`` the caller passes. The JAX ``deterministic`` flag
(predictor dropout) is ``module.training`` here: the trainer switches
``train()``/``eval()`` around ``train_loss``/``eval_loss``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import randn
from ..trace import span
from .nn import ConvNormAct, DeconvNormAct, LayerNorm, SoftPositionEmbed
from .predictor import build_predictor
from .slot_attention import SlotAttention, SlotAttentionWMask


def _adopt(parent: nn.Module, attr: str, part: nn.Module) -> None:
    """Register ``part``'s children on ``parent`` under their own names, as
    the reference's flat state_dict has them, and keep ``part`` as
    ``parent.<attr>`` without registering it. ``part`` runs on those same
    children, so ``parent.to()``, ``.eval()`` and ``load_state_dict`` reach
    everything it uses."""
    for name, child in part.named_children():
        parent.add_module(name, child)
    object.__setattr__(parent, attr, part)


class KernelDistLayer(nn.Sequential):
    """Predict (mu, log_var) of the stochastic SA kernels, [.., 2D].

    ``kernel_mlp=True``: Linear, LN, ReLU, Linear; False: one Linear (the
    CLEVRER config)."""

    def __init__(self, slot_size: int, kernel_mlp: bool = True):
        d2 = slot_size * 2
        if kernel_mlp:
            layers = [nn.Linear(slot_size, d2), LayerNorm(d2), nn.ReLU(),
                      nn.Linear(d2, d2)]
        else:
            layers = [nn.Linear(slot_size, d2)]
        super().__init__(*layers)


class SAViCell(nn.Module):
    """One temporal step: predict -> (sample) kernels -> slot attention.

    ``use_kernel_head=False`` is STEVE's deterministic cell: no kernel head,
    the predictor's output seeds slot attention itself; ``with_mask`` runs
    ``SlotAttentionWMask`` and returns its masks."""

    def __init__(self, slot_size: int, slot_mlp_size: int, num_slots: int,
                 num_iterations: int, in_features: int, pred_dict: dict,
                 kernel_mlp: bool, stochastic: bool, with_mask: bool = False,
                 use_kernel_head: bool = True, eps: float = 1e-6):
        super().__init__()
        self.predictor = build_predictor(slot_size, slot_mlp_size, pred_dict)
        if use_kernel_head:
            self.kernel_dist_layer = KernelDistLayer(slot_size, kernel_mlp)
        sa_cls = SlotAttentionWMask if with_mask else SlotAttention
        self.slot_attention = sa_cls(
            in_features, num_iterations, num_slots, slot_size, slot_mlp_size,
            eps)
        self.stochastic = stochastic
        self.with_mask = with_mask
        self.use_kernel_head = use_kernel_head

    def forward(self, carry, kv_t, is_first: bool,
                eps_t: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                sa_weights: Optional[dict] = None):
        """``carry`` = (slots [B, S, D], predictor state); ``kv_t`` = this
        frame's (k, v); ``sa_weights``: ``SlotAttention.packed_weights()``,
        packed in this step when not given. Returns (carry, (kernel_dist,
        post_slots, masks [B, S, N] or None without ``with_mask``))."""
        slots, pred_state = carry
        if is_first:
            # a fresh video: SA is seeded from the init latents themselves
            # and the predictor state does not advance
            latents = slots
        else:
            latents, pred_state = self.predictor(slots, pred_state)
        if not self.use_kernel_head:
            kernel_dist = torch.cat([latents, torch.zeros_like(latents)], -1)
            kernels = latents
        else:
            kernel_dist = self.kernel_dist_layer(latents)
            mu, log_var = kernel_dist.chunk(2, dim=-1)
            if not self.stochastic:
                kernels = mu
            else:
                if eps_t is None:
                    if generator is None:
                        raise ValueError("a stochastic encode needs sample_eps "
                                         "or a torch.Generator")
                    eps_t = randn(mu.shape, generator, mu.device, mu.dtype)
                kernels = mu + eps_t * torch.exp(0.5 * log_var)
        out = self.slot_attention(None, kernels, kv=kv_t, weights=sa_weights)
        post_slots, masks = out if self.with_mask else (out, None)
        return (post_slots, pred_state), (kernel_dist, post_slots, masks)


class FrameEncoder(nn.Module):
    """CNN -> SoftPositionEmbed -> LN-MLP head over one frame:
    [B', H, W, 3] NHWC -> [B', H'*W', C]."""

    def __init__(self, resolution: Tuple[int, int], enc_dict: dict = None):
        super().__init__()
        ed = enc_dict or {}
        channels = list(ed.get("enc_channels", (3, 64, 64, 64, 64)))
        ks = ed.get("enc_ks", 5)
        norm = ed.get("enc_norm", "")
        out_channels = ed.get("enc_out_channels", 128)
        n_layers = len(channels) - 1
        # stride-2 first layer iff the input is 128 wide, as the reference
        stride0 = 2 if resolution[0] == 128 else 1
        self.encoder = nn.Sequential(*[
            ConvNormAct(channels[i], channels[i + 1], ks,
                        stride=stride0 if i == 0 else 1, norm=norm,
                        act="relu" if i != n_layers - 1 else "")
            for i in range(n_layers)
        ])
        self.encoder_pos_embedding = SoftPositionEmbed(
            channels[-1], (resolution[0] // stride0, resolution[1] // stride0))
        self.encoder_out_layer = nn.Sequential(
            LayerNorm(channels[-1]), nn.Linear(channels[-1], out_channels),
            nn.ReLU(), nn.Linear(out_channels, out_channels))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.encoder(img.permute(0, 3, 1, 2))
        x = self.encoder_pos_embedding(x)
        x = x.flatten(2).transpose(1, 2)  # [B', H'*W', C], row-major pixels
        return self.encoder_out_layer(x)


class SpatialBroadcastDecoder(nn.Module):
    """Spatial-broadcast slot decoder with softmax-over-slots compositing;
    shared by StoSAVi and SlotFormer."""

    def __init__(self, resolution: Tuple[int, int], slot_size: int,
                 dec_dict: dict = None):
        super().__init__()
        dd = dec_dict or {}
        channels = list(dd.get("dec_channels", (128, 64, 64, 64, 64)))
        self.dec_resolution = tuple(dd.get("dec_resolution", (8, 8)))
        ks = dd.get("dec_ks", 5)
        norm = dd.get("dec_norm", "")
        if channels[0] != slot_size:
            raise ValueError("dec_channels[0] must equal slot_size")
        layers = []
        out_size, stride = self.dec_resolution[0], 2
        for i in range(len(channels) - 1):
            if out_size == resolution[0]:
                stride = 1
            layers.append(DeconvNormAct(channels[i], channels[i + 1], ks,
                                        stride, norm=norm, act="relu"))
            out_size *= stride
        if out_size != resolution[0]:
            raise ValueError(f"decoder output {out_size} != resolution "
                             f"{resolution}; adjust dec_resolution")
        layers.append(nn.Conv2d(channels[-1], 4, kernel_size=1))
        self.decoder = nn.Sequential(*layers)
        self.decoder_pos_embedding = SoftPositionEmbed(slot_size,
                                                       self.dec_resolution)

    def forward(self, slots: torch.Tensor):
        """[B', S, D] -> (recon_combined [B', H, W, 3], recons
        [B', S, H, W, 3], masks [B', S, H, W, 1], slots), NHWC."""
        B, S, D = slots.shape
        H0, W0 = self.dec_resolution
        x = slots.reshape(B * S, D, 1, 1).expand(B * S, D, H0, W0)
        x = self.decoder(self.decoder_pos_embedding(x))  # [B*S, 4, H, W]
        x = x.permute(0, 2, 3, 1).reshape(B, S, *x.shape[2:], 4)
        recons = x[..., :3]
        masks = torch.softmax(x[..., 3:], dim=1)
        recon_combined = (recons * masks).sum(dim=1)
        return recon_combined, recons, masks, slots


def encode_frames(model: nn.Module, img: torch.Tensor,
                  prev_slots: Optional[torch.Tensor] = None, pred_state=None,
                  sample_eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
    """The temporal encode of StoSAVi and STEVE (``model`` has
    ``frame_encoder``, ``cell``, ``init_latents`` and ``init_pred_state``):
    [B, T, H, W, 3] -> (kernel_dist [B, T, S, 2D], slots [B, T, S, D], masks
    [B, T, S, N] or None, encoder_out [B, T, N, C], carry)."""
    B, T = img.shape[:2]
    feats = model.frame_encoder(img.reshape(B * T, *img.shape[2:]))
    # the SA input LN + k/v projections depend only on the features: one
    # batched call over all B*T frames. [T, B, N, D] so each frame's k/v is
    # contiguous, as the kernel takes them.
    cell = model.cell
    k_all, v_all = cell.slot_attention.project_kv(feats)
    k_all = k_all.reshape(B, T, *k_all.shape[1:]).transpose(0, 1).contiguous()
    v_all = v_all.reshape(B, T, *v_all.shape[1:]).transpose(0, 1).contiguous()
    feats = feats.reshape(B, T, *feats.shape[1:])

    first = prev_slots is None
    slots = model.init_latents.expand(B, -1, -1) if first else prev_slots
    carry = (slots, model.init_pred_state(B) if pred_state is None
             else pred_state)
    # the slot-attention weights do not change between the frame steps:
    # packed into the kernel's buffers once per encode, never kept across
    # calls (an optimizer step may lie between two of them)
    sa_weights = cell.slot_attention.packed_weights()
    steps = []
    for t in range(T):
        with span("savi.frame_step"):
            eps_t = None if sample_eps is None else sample_eps[:, t]
            carry, out = cell(carry, (k_all[t], v_all[t]), first and t == 0,
                              eps_t, generator, sa_weights)
        steps.append(out)
    kernel_dist, post_slots, masks = (
        None if parts[0] is None else torch.stack(parts, 1)
        for parts in zip(*steps))
    return kernel_dist, post_slots, masks, feats, carry


class StoSAVi(nn.Module):
    """Stochastic SAVi video slot encoder (constructor mirrors the
    reference's config-dict surface)."""

    def __init__(self, resolution: Tuple[int, int], clip_len: int = 6,
                 slot_dict: dict = None, enc_dict: dict = None,
                 dec_dict: dict = None, pred_dict: dict = None,
                 loss_dict: dict = None, eps: float = 1e-6):
        super().__init__()
        sd = slot_dict or {}
        ed = enc_dict or {}
        self.resolution = tuple(resolution)
        self.clip_len = clip_len
        self.num_slots = sd.get("num_slots", 7)
        self.slot_size = sd.get("slot_size", 128)
        self.slot_mlp_size = sd.get("slot_mlp_size", 256)
        self.num_iterations = sd.get("num_iterations", 2)
        ld = loss_dict or {}
        self.use_post_recon_loss = ld.get("use_post_recon_loss", True)
        # 'var-<prior variance>' samples the SA kernels and penalises their
        # KLD to a prior of that variance; 'none' does neither
        kld_method = ld.get("kld_method", "var-0.01")
        kld_var = 1.0
        if "-" in kld_method:
            kld_method, kld_var = kld_method.split("-")
        if kld_method not in ("var", "none"):
            raise ValueError(f"kld_method {kld_method!r}")
        self.kld_method = kld_method
        self.kld_log_var = math.log(float(kld_var))

        self.init_latents = nn.Parameter(
            torch.randn(1, self.num_slots, self.slot_size))
        _adopt(self, "frame_encoder", FrameEncoder(self.resolution, ed))
        _adopt(self, "spatial_decoder", SpatialBroadcastDecoder(
            self.resolution, self.slot_size, dec_dict))
        _adopt(self, "cell", SAViCell(
            slot_size=self.slot_size, slot_mlp_size=self.slot_mlp_size,
            num_slots=self.num_slots, num_iterations=self.num_iterations,
            in_features=ed.get("enc_out_channels", 128),
            pred_dict=pred_dict or dict(pred_type="transformer",
                                        pred_rnn=True),
            kernel_mlp=sd.get("kernel_mlp", True),
            stochastic=kld_method != "none", eps=eps))

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """Load a reference-layout state_dict; ``prior_slot_layer.*`` (unused
        by the reference's forward) is skipped."""
        state_dict = {k: v for k, v in state_dict.items()
                      if not k.startswith("prior_slot_layer.")}
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def init_pred_state(self, batch_size: int):
        return self.cell.predictor.init_state(batch_size, self.num_slots)

    def encode(self, img: torch.Tensor, prev_slots: Optional[torch.Tensor] = None,
               pred_state=None, sample_eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """[B, T, H, W, 3] -> (kernel_dist [B, T, S, 2D], post_slots
        [B, T, S, D], encoder_out [B, T, H'*W', C], carry).

        ``prev_slots``/``pred_state`` (the ``carry`` of the previous call)
        continue a chunked long video; then no frame is a first frame.
        """
        kernel_dist, post_slots, _, feats, carry = encode_frames(
            self, img, prev_slots, pred_state, sample_eps, generator)
        return kernel_dist, post_slots, feats, carry

    def decode(self, slots: torch.Tensor):
        """[B', S, D] -> (recon_combined, recons, masks, slots), NHWC."""
        return self.spatial_decoder(slots)

    def forward(self, batch: dict, testing: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        img = batch["img"]
        B, T = img.shape[:2]
        kernel_dist, post_slots, _, _ = self.encode(
            img, sample_eps=batch.get("sample_eps"), generator=generator)
        out = {"post_slots": post_slots, "kernel_dist": kernel_dist, "img": img}
        if testing or not self.use_post_recon_loss:
            return out
        flat = post_slots.reshape(B * T, self.num_slots, self.slot_size)
        recon_combined, recons, masks, _ = self.decode(flat)
        out["post_recon_combined"] = recon_combined.reshape(
            B, T, *recon_combined.shape[1:])
        out["post_recons"] = recons.reshape(B, T, *recons.shape[1:])
        out["post_masks"] = masks.reshape(B, T, *masks.shape[1:])
        return out

    # ---------------------------------------------------------------- losses
    def _kld_loss(self, kernel_dist: torch.Tensor) -> torch.Tensor:
        """KLD(N(mu, sigma) || N(stopgrad(mu), prior_sigma)): no mu penalty."""
        if self.kld_method == "none":
            return kernel_dist.new_zeros(())
        log_var = kernel_dist[..., self.slot_size:]
        kld = (0.5 * (self.kld_log_var - log_var)
               + torch.exp(log_var) / (2.0 * math.exp(self.kld_log_var)) - 0.5)
        return kld.sum(-1).mean()

    def calc_train_loss(self, batch: dict, out: dict) -> dict:
        loss = {"kld_loss": self._kld_loss(out["kernel_dist"])}
        if self.use_post_recon_loss:
            loss["post_recon_loss"] = (
                (out["post_recon_combined"] - out["img"]) ** 2).mean()
        return loss

    def train_loss(self, batch: dict,
                   generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` (call in ``train()`` mode)."""
        return self.calc_train_loss(batch, self(batch, generator=generator))

    def eval_loss(self, batch: dict,
                  generator: Optional[torch.Generator] = None) -> dict:
        """The loss dict of ``batch`` (call in ``eval()`` mode)."""
        return self.calc_train_loss(batch, self(batch, generator=generator))
