"""Roll out slots with a trained SlotFormer or STEVESlotFormer, the port of
``slotformer_tpu/cli/rollout_slots.py``.

Every video's slots are extended from ``obs_frames`` to ``target_len``
frames with frame-offset interleaving: for offset k, the phase sequences
``[off::k]`` are rolled out separately and then re-interleaved. Output
pickle ``{split: {fn: [target_len, N, C]}}``, symlinked next to the weight.

  * ``--task clevrer``: ``params.slots_root``, 128 -> 160 frames, every
    split, link ``rollout_slots.pkl``;
  * ``--task physion``: ``{subset}_slots.pkl`` beside ``params.slots_root``
    (what ``cli/extract_slots.py`` links), 45 observed frames (1.5 s at 30
    fps) -> ``params.video_len``, the readout subset's train/val or the test
    subset's test, link ``{subset}_slots.pkl``;
  * ``--task synthetic``: ``params.slots_root``, ``--obs_frames`` and
    ``--target_len`` required, link ``rollout_slots.pkl``.

Usage:
    python -m slotformer_tpu_torch.cli.rollout_slots --task clevrer \
        --params <cfg.py> --weight <ckpt.pth> --save_path rollout_slots.pkl
    python -m slotformer_tpu_torch.cli.rollout_slots --task physion \
        --subset readout --params <cfg.py> --weight <ckpt.pth> \
        --save_path readout_rollout_slots.pkl
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


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="rollout slots via SlotFormer")
    parser.add_argument("--task", choices=["clevrer", "physion", "synthetic"],
                        required=True)
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True,
                        help="reference-format {'state_dict': ...} file")
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--subset", default="readout",
                        help="physion only: readout | test")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--obs_frames", type=int, default=-1,
                        help="default: 128 (clevrer), 45 (physion)")
    parser.add_argument("--target_len", type=int, default=-1,
                        help="default: 160 (clevrer), video_len (physion)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..models import build_model
    from ..runtime import dump_obj, load_obj, load_params, symlink_force
    from ..runtime.checkpoint import load_checkpoint

    params = load_params(args.params)
    params.loss_dict["use_img_recon_loss"] = False
    model = build_model(params, device=args.device)
    model.load_state_dict(load_checkpoint(args.weight)["state_dict"])

    obs_frames, target_len = args.obs_frames, args.target_len
    slots_root, link_name = params.slots_root, "rollout_slots.pkl"
    splits = ("val", "train", "test")
    if args.task == "clevrer":
        obs_frames = 128 if obs_frames < 0 else obs_frames
        target_len = 160 if target_len < 0 else target_len
    elif args.task == "physion":
        if args.subset not in ("readout", "test"):
            raise ValueError(f"physion --subset must be readout|test, got "
                             f"{args.subset!r}")
        if args.subset not in args.save_path:
            raise ValueError("name the physion subset in --save_path, to tell "
                             "the slot files apart")
        obs_frames = 45 if obs_frames < 0 else obs_frames
        target_len = params.get("video_len", 150) if target_len < 0 else target_len
        slots_root = os.path.join(os.path.dirname(params.slots_root),
                                  f"{args.subset}_slots.pkl")
        splits = ("test",) if args.subset == "test" else ("train", "val")
        # what the readout heads look for next to the SlotFormer weight
        link_name = f"{args.subset}_slots.pkl"
    elif obs_frames <= 0 or target_len <= 0:
        raise ValueError("--task synthetic needs --obs_frames and --target_len")

    all_slots = load_obj(slots_root)
    out = {}
    for split in splits:
        if split not in all_slots:
            continue
        print(f"[rollout] split={split} videos={len(all_slots[split])}",
              flush=True)
        out[split] = interleaved_rollout(
            model, all_slots[split], obs_frames, target_len,
            params.input_frames, params.frame_offset, args.batch_size)
    dump_obj(out, args.save_path)
    print(f"[rollout] saved -> {args.save_path}", flush=True)
    link = os.path.join(os.path.dirname(os.path.abspath(args.weight)), link_name)
    symlink_force(args.save_path, link)
    return args.save_path


if __name__ == "__main__":
    main()
