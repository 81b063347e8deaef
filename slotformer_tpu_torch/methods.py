"""Per-model training methods and ``build_method``: the port of
``slotformer_tpu/methods.py`` for the models the port trains (StoSAVi, SAVi,
SlotFormer).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from .runtime.checkpoint import graft, load_checkpoint
from .runtime.io import save_video
from .runtime.method import BaseMethod


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


_METHODS = {"StoSAVi": SAViMethod, "SAVi": SAViMethod,
            "SlotFormer": SlotFormerMethod}


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
