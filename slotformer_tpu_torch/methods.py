"""Per-model training methods and ``build_method``: the port of
``slotformer_tpu/methods.py`` for the models the port trains (StoSAVi, SAVi,
SlotFormer; the STEVE family: dVAE, STEVE, STEVESlotFormer).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .runtime.checkpoint import graft, load_checkpoint
from .runtime.io import save_video
from .runtime.method import BaseMethod
from .runtime.schedules import cosine_anneal


class SAViMethod(BaseMethod):
    """StoSAVi / SAVi training (reference base_slots/method.py:99-162)."""

    @torch.no_grad()
    def _sample_video(self) -> None:
        """Save per-slot decomposition grids, one row a video: [gt | recon |
        slot_0..N] (reference _make_video_grid, base_slots/method.py:102-131),
        to ``<ckp>/vis/decomp_<it>.mp4``."""
        n = int(self.params.get("n_samples", 5))
        gen = torch.Generator(self.device).manual_seed(0)
        rows = []
        for v in self._sample_val_videos(n):
            img = torch.from_numpy(np.asarray(v["video"])[None]).to(self.device)
            out = self.model({"img": img}, generator=gen)
            recon = out["post_recon_combined"][0].cpu().numpy()
            recons = out["post_recons"][0].cpu().numpy()
            masks = out["post_masks"][0].cpu().numpy()
            per_slot = recons * masks + (1.0 - masks)  # white background
            panels = [v["video"], recon] + [per_slot[:, s]
                                            for s in range(per_slot.shape[1])]
            rows.append(np.concatenate(panels, axis=2))  # side by side
        grid = np.clip(np.concatenate(rows, axis=1) * 0.5 + 0.5, 0, 1)
        save_video(grid, os.path.join(self._vis_dir(), f"decomp_{self.it}.mp4"),
                   fps=8)


class SlotFormerMethod(BaseMethod):
    """SlotFormer training: the frozen SAVi decoder and the temporal
    loss-decay ramp (reference video_prediction/method.py:24-62)."""

    frozen_prefixes = ("decoder",)  # decoder.* and decoder_pos_embedding.*

    def setup_state(self) -> None:
        """Graft the decoder of the pretrained SAVi checkpoint
        ``dec_dict['dec_ckp_path']`` (a checkpoint of this program or a
        reference ``.pth``) when it is set."""
        ckp = (self.params.get("dec_dict") or {}).get("dec_ckp_path", "")
        if ckp:
            grafted = graft(self.model.state_dict(), load_checkpoint(ckp),
                            ("decoder", "decoder_pos_embedding"))
            self.model.load_state_dict(grafted)
        super().setup_state()

    def train_loss_kwargs(self, step: int) -> Dict[str, float]:
        if not self.params.get("use_loss_decay", False):
            return {}
        decay_steps = (float(self.params.get("loss_decay_pct", 0.0))
                       * self.total_steps)
        if decay_steps <= 0:
            return {}
        # the decay factor rises linearly 0.01 -> 1 over decay_steps
        return {"loss_decay_factor": min(0.01 + step / decay_steps * 0.99, 1.0)}

    @torch.no_grad()
    def _sample_video(self) -> None:
        """Save [gt | decoded gt slots | rollout] comparison videos, one row
        a video (reference video_prediction/method.py:142-183), to
        ``<ckp>/vis/rollout_<it>.mp4``."""
        dst = self.val_loader.dataset
        slots_dict = getattr(dst, "video_slots", None)
        if slots_dict is None:
            raise NotImplementedError
        base = dst.base if hasattr(dst, "base") else dst
        n = int(self.params.get("n_samples", 5))
        history = int(self.params.input_frames)
        offset = int(self.params.get("frame_offset", 1) or 1)
        rows = []
        for v in self._sample_val_videos(n):
            fn = os.path.basename(base.files[v["data_idx"]])
            if fn not in slots_dict:
                continue
            slots = np.asarray(slots_dict[fn][::offset], np.float32)
            gt = np.asarray(v["video"])
            T = min(len(slots), len(gt))
            slots_t = torch.from_numpy(slots[:T]).to(self.device)
            recon = self.model.decode(slots_t)[0].cpu().numpy()  # [T, H, W, 3]
            ro = self.model.rollout(slots_t[None, :history], T - history,
                                    decode=True)["recon_combined"][0]
            rows.append(np.concatenate([gt[:T], recon, ro.cpu().numpy()], axis=2))
        if not rows:
            return
        grid = np.clip(np.concatenate(rows, axis=1) * 0.5 + 0.5, 0, 1)
        save_video(grid, os.path.join(self._vis_dir(), f"rollout_{self.it}.mp4"),
                   fps=8)


class STEVESlotFormerMethod(SlotFormerMethod):
    """SlotFormer over STEVE slots: the frozen dVAE and STEVE token decoder
    grafted from the STEVE checkpoint (reference steve_slotformer.py:62-84).
    The token decoder keeps the reference's name ``decoder`` here, where the
    STEVE checkpoint (and the JAX package) calls it ``trans_decoder``."""

    frozen_prefixes = ("decoder", "dvae")

    def setup_state(self) -> None:
        """Graft ``decoder`` <- ``trans_decoder`` and ``dvae`` <- ``dvae``
        from ``dec_dict['dec_ckp_path']`` when it is set. SlotFormer's own
        graft (the SAVi decoder and its position embedding) does not run."""
        ckp = (self.params.get("dec_dict") or {}).get("dec_ckp_path", "")
        if ckp:
            grafted = graft(self.model.state_dict(), load_checkpoint(ckp),
                            {"decoder": "trans_decoder", "dvae": "dvae"})
            self.model.load_state_dict(grafted)
        BaseMethod.setup_state(self)


class dVAEMethod(BaseMethod):  # noqa: N801 (the reference's name)
    """dVAE training with the gumbel temperature annealed per step
    (reference base_slots/method.py:165-231)."""

    def train_loss_kwargs(self, step: int) -> Dict[str, float]:
        """``tau``: cosine from ``init_tau`` to ``final_tau`` over the first
        ``tau_decay_pct`` of the steps, then held."""
        decay_steps = float(self.params.get("tau_decay_pct", 0.3)) * self.total_steps
        return {"tau": cosine_anneal(
            step, float(self.params.get("init_tau", 1.0)),
            float(self.params.get("final_tau", 0.1)), 0, int(decay_steps))}

    @torch.no_grad()
    def _sample_video(self) -> None:
        """Save [gt | hard-token recon] rows, one a video (reference
        base_slots/method.py:168-205), to ``<ckp>/vis/recon_<it>.mp4``."""
        n = int(self.params.get("n_samples", 5))
        gen = torch.Generator(self.device).manual_seed(0)
        rows = []
        for v in self._sample_val_videos(n):
            img = torch.from_numpy(np.asarray(v["video"])[None]).to(self.device)
            recon = self.model({"img": img}, tau=1.0, hard=True,
                               generator=gen)["recon"][0].cpu().numpy()
            rows.append(np.concatenate([v["video"], recon], axis=2))
        grid = np.clip(np.concatenate(rows, axis=1) * 0.5 + 0.5, 0, 1)
        save_video(grid, os.path.join(self._vis_dir(), f"recon_{self.it}.mp4"),
                   fps=8)


class STEVEMethod(BaseMethod):
    """STEVE training on a frozen pretrained dVAE; the token decoder
    (``trans_decoder``) trains at ``dec_lr`` in a group of its own
    (``runtime.schedules.build_optimizer``; reference
    base_slots/method.py:234-276)."""

    frozen_prefixes = ("dvae",)

    def setup_state(self) -> None:
        """Graft ``dvae`` from ``dvae_dict['dvae_ckp_path']``: from its
        ``dvae.*`` keys when it has them (a STEVE checkpoint), else from its
        root (a dVAE trainer's checkpoint)."""
        ckp = (self.params.get("dvae_dict") or {}).get("dvae_ckp_path", "")
        if not ckp:
            raise ValueError("STEVE trains on a pretrained dVAE: set "
                             "dvae_dict['dvae_ckp_path']")
        src = load_checkpoint(ckp)["state_dict"]
        src_prefix = "dvae" if any(k.startswith("dvae.") for k in src) else ""
        self.model.load_state_dict(
            graft(self.model.state_dict(), src, {"dvae": src_prefix}))
        super().setup_state()

    @torch.no_grad()
    def _sample_video(self) -> None:
        """Save per-slot masked decompositions [gt | slot_0..N], one row a
        video, with the masks upsampled to the frames (the reference skips
        the autoregressive reconstruction here too:
        base_slots/method.py:285-291), to ``<ckp>/vis/decomp_<it>.mp4``."""
        n = int(self.params.get("n_samples", 5))
        rows = []
        for v in self._sample_val_videos(n):
            video = np.asarray(v["video"])
            img = torch.from_numpy(video[None]).to(self.device)
            masks = self.model({"img": img}, testing=True)["masks"][0]
            masked = video[:, None] * masks.cpu().numpy()[..., None]
            panels = [video] + [masked[:, s] for s in range(masked.shape[1])]
            rows.append(np.concatenate(panels, axis=2))
        grid = np.clip(np.concatenate(rows, axis=1) * 0.5 + 0.5, 0, 1)
        save_video(grid, os.path.join(self._vis_dir(), f"decomp_{self.it}.mp4"),
                   fps=8)


_METHODS = {"StoSAVi": SAViMethod, "SAVi": SAViMethod,
            "SlotFormer": SlotFormerMethod, "dVAE": dVAEMethod,
            "STEVE": STEVEMethod, "STEVESlotFormer": STEVESlotFormerMethod}


def build_method(model=None, datamodule=None, params=None, ckp_path="",
                 local_rank=0, use_ddp=False, use_fp16=False, **kw):
    """The trainer of ``params.model`` (reference signature,
    scripts/train.py:65-73)."""
    cls = _METHODS.get(params.model)
    if cls is None:
        raise NotImplementedError(
            f"training {params.model} is not ported yet (ported: "
            f"{sorted(_METHODS)})")
    return cls(model=model, datamodule=datamodule, params=params,
               ckp_path=ckp_path, local_rank=local_rank, use_ddp=use_ddp,
               use_fp16=use_fp16, **kw)
