"""Roll out slots with a trained SlotFormer (CLEVRER), the port of
``slotformer_tpu/cli/rollout_slots.py``.

Every video's slots are extended from ``obs_frames`` to ``target_len``
frames (CLEVRER: 128 -> 160) with frame-offset interleaving: for offset k,
the phase sequences ``[off::k]`` are rolled out separately and then
re-interleaved. Output pickle ``{split: {fn: [target_len, N, C]}}``,
symlinked as ``rollout_slots.pkl`` next to the weight.

Usage:
    python -m slotformer_tpu_torch.cli.rollout_slots --task clevrer \
        --params <cfg.py> --weight <ckpt.pth> --save_path rollout_slots.pkl
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch


def interleaved_rollout(model, slots_dict: Dict[str, np.ndarray],
                        obs_frames: int, target_len: int, history_len: int,
                        frame_offset: int, batch_size: int = 8
                        ) -> Dict[str, np.ndarray]:
    """Extend every [obs, N, C] slot sequence to [target_len, N, C] with the
    SlotFormer ``model`` on its device."""
    if (target_len - obs_frames) % frame_offset:
        raise ValueError("frame_offset must divide the rollout span for "
                         "uniform phase lengths")
    device = next(model.parameters()).device
    names = list(slots_dict.keys())
    out = {}
    for i0 in range(0, len(names), batch_size):
        batch_names = names[i0:i0 + batch_size]
        obs = np.stack([slots_dict[n][:obs_frames]
                        for n in batch_names]).astype(np.float32)
        pad = np.zeros((obs.shape[0], target_len - obs_frames) + obs.shape[2:],
                       np.float32)
        ori = np.concatenate([obs, pad], axis=1)  # [B, target, N, C]
        phase_preds = []
        for off in range(frame_offset):
            start = obs_frames - history_len * frame_offset + off
            in_slots = ori[:, start::frame_offset]  # [B, hist+ro, N, C]
            past = torch.from_numpy(
                np.ascontiguousarray(in_slots[:, :history_len])).to(device)
            with torch.inference_mode():
                pred = model.rollout(past, in_slots.shape[1] - history_len)
            phase_preds.append(pred.cpu().numpy())
        # re-interleave: global step i -> phase i % offset, step i // offset
        pred = np.stack([phase_preds[i % frame_offset][:, i // frame_offset]
                         for i in range(target_len - obs_frames)], axis=1)
        full = np.concatenate([obs, pred], axis=1)
        for k, n in enumerate(batch_names):
            out[n] = full[k].astype(np.float32)
        print(f"  {min(i0 + batch_size, len(names))}/{len(names)} videos",
              flush=True)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="rollout slots via SlotFormer")
    parser.add_argument("--task", choices=["clevrer"], required=True)
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True,
                        help="reference-format {'state_dict': ...} file")
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--obs_frames", type=int, default=128)
    parser.add_argument("--target_len", type=int, default=160)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..models import build_model
    from ..runtime import dump_obj, load_obj, load_params, symlink_force
    from ..runtime.checkpoint import load_checkpoint

    params = load_params(args.params)
    params.loss_dict["use_img_recon_loss"] = False
    model = build_model(params, device=args.device)
    model.load_state_dict(load_checkpoint(args.weight)["state_dict"])

    all_slots = load_obj(params.slots_root)
    out = {}
    for split in ("val", "train", "test"):
        if split not in all_slots:
            continue
        print(f"[rollout] split={split} videos={len(all_slots[split])}",
              flush=True)
        out[split] = interleaved_rollout(
            model, all_slots[split], args.obs_frames, args.target_len,
            params.input_frames, params.frame_offset, args.batch_size)
    dump_obj(out, args.save_path)
    print(f"[rollout] saved -> {args.save_path}", flush=True)
    link = os.path.join(os.path.dirname(os.path.abspath(args.weight)),
                        "rollout_slots.pkl")
    symlink_force(args.save_path, link)


if __name__ == "__main__":
    main()
