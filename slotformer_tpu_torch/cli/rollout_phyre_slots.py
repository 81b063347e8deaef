"""PHYRE slot rollout: SingleStepSlotFormer from each action's first slots,
the port of ``slotformer_tpu/cli/rollout_phyre_slots.py``.

For the val and train splits, each action's slot file (written by
``cli/extract_phyre_slots.py``; ``params.slots_root`` is its ``{}`` pattern
of the split) is brought to ``video_len`` frames, the model rolls out
``video_len - 1`` frames from its first, and ``[obs_slot_0, pred_slots...]``
[video_len, N, C] is written as ``{idx:06d}.npy`` under
``<save_path>/rollout_slots/<config name>/<protocal>-fold_<fold>-<split>/``,
linked as ``<split>_slots`` next to the weight (by shard 0, or by an
unsharded run). ``--split K --total_split N`` rolls out the K-th of N equal
ranges of actions; a batch whose files all exist is skipped, so a restart
resumes. Actions without a slot file are left out. No simulator is needed:
the split files list the actions.

Usage:
    python -m slotformer_tpu_torch.cli.rollout_phyre_slots --params <cfg.py> \
        --weight <ckpt.pth> --save_path ./data/PHYRE
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch

from ..parallel.mesh import local_devices, replicas, spread_rows

from ..datasets import phyre as phyre_data
from .extract_phyre_slots import _action_range


def rollout_split(model, dataset, save_root: str, args) -> int:
    """Roll out the actions of ``dataset`` (a ``PHYRESlotsDataset`` whose
    ``seq_size`` is the video's length) with ``model`` on its device, or
    with a list of its replicas (``parallel.replicas``), a batch's rows
    spread over their devices, into ``save_root``; returns the actions
    written."""
    from ..runtime.io import atomic_write_npy

    models = list(model) if isinstance(model, (list, tuple)) else [model]
    start, end = _action_range(len(dataset), args.split, args.total_split)
    written = 0
    for i0 in range(start, end, args.bs):
        idxs = range(i0, min(i0 + args.bs, end))
        if all(osp.exists(osp.join(save_root, f"{i:06d}.npy")) for i in idxs):
            continue  # written by an earlier run
        found, slots = [], []
        for i in idxs:
            try:
                slots.append(dataset._read_slots(i)["slots"])
                found.append(i)
            except FileNotFoundError:
                pass
        if not found:
            continue
        slots = np.stack(slots)

        def roll(_, m, lo, hi):
            batch = torch.from_numpy(slots[lo:hi]).to(next(m.parameters()).device)
            with torch.inference_mode():
                pred = m.rollout(batch[:, :1], batch.shape[1] - 1)
                return torch.cat([batch[:, :1], pred], 1).float()

        full = spread_rows(roll, models, len(slots))
        for k, i in enumerate(found):
            atomic_write_npy(full[k], osp.join(save_root, f"{i:06d}.npy"))
        written += len(found)
        print(f"  {idxs[-1] + 1}/{end}", flush=True)
    return written


def main(argv=None) -> dict:
    """Returns ``{split: the directory of its rolled-out slot files}``."""
    parser = argparse.ArgumentParser(description="rollout PHYRE slots")
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True,
                        help="reference-format {'state_dict': ...} file")
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--split", type=int, default=-1)
    parser.add_argument("--total_split", type=int, default=10)
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..models import build_model
    from ..runtime import load_checkpoint, load_params, symlink_force

    params = load_params(args.params)
    params.loss_dict["use_img_recon_loss"] = False
    # the rollout covers the whole video from frame 0
    params.loss_dict["rollout_len"] = params.video_len - 1
    model = build_model(params, device=args.device)
    model.load_state_dict(load_checkpoint(args.weight)["state_dict"])
    models = replicas(model, local_devices(args.device))
    stem = os.path.splitext(os.path.basename(args.params))[0]
    out = {}
    for split in ("val", "train"):
        # the split files were written by the extraction: no simulator
        ds = phyre_data.PHYRESlotsDataset(
            slot_root=params.slots_root.format(split),
            **dict(phyre_data._args(params, split), seq_size=params.video_len))
        save_root = osp.join(args.save_path, "rollout_slots", stem,
                             f"{ds.protocal}-fold_{ds.fold}-{split}")
        os.makedirs(save_root, exist_ok=True)
        if args.split in (-1, 0):
            symlink_force(save_root, osp.join(
                osp.dirname(osp.abspath(args.weight)), f"{split}_slots"))
        print(f"[rollout_phyre] split={split} actions={len(ds)}", flush=True)
        rollout_split(models, ds, save_root, args)
        out[split] = save_root
    return out


if __name__ == "__main__":
    main()
