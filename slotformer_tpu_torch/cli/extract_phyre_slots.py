"""PHYRE slot extraction: a frozen SAVi over the simulated action videos, the
port of ``slotformer_tpu/cli/extract_phyre_slots.py``.

Each action of the val and train splits is simulated to ``--vid_len`` frames
(times ``fps``) and encoded; one ``{idx:06d}.npy`` [vid_len, N, C] float32
per action is written, trimmed to the video's real length, under
``<save_path>/slots/<config name>/<protocal>-fold_<fold>-<split>-data_<ratio>
-pos_<pos_ratio>/``, and that directory is linked as ``<split>_slots`` next
to the weight (by shard 0, or by an unsharded run). ``--split K
--total_split N`` extracts the K-th of N equal ranges of actions; a sharded
run resumes at the batch of the last file it finds. StoSAVi's kernel noise
(when its ``kld_method`` samples) comes from a generator seeded with the
index of the batch's first action; a resumed run keeps the batches of a
whole one, so it draws what a whole one would.

Usage:
    python -m slotformer_tpu_torch.cli.extract_phyre_slots --params <cfg.py> \
        --weight <ckpt.pth> --save_path ./data/PHYRE [--split K --total_split N]
"""

from __future__ import annotations

import argparse
import os

import torch

from ..parallel.mesh import RowShard, local_devices, replicas, spread_rows


def _action_range(total: int, split: int, total_split: int):
    """The [start, end) actions of shard ``split`` of ``total_split`` (all
    of them for -1)."""
    if split == -1:
        return 0, total
    per = total // total_split
    end = per * (split + 1) if split < total_split - 1 else total
    return per * split, end


def extract_phyre_video_slots(model, dataset, save_root: str, args,
                              num_workers: int = 4) -> int:
    """Encode the actions of ``dataset`` (a ``PHYREDataset``) with the SAVi
    ``model`` on its device, or with a list of its replicas
    (``parallel.replicas``), a batch's rows spread over their devices, into
    ``save_root``; returns the actions written."""
    from ..runtime import DataLoader
    from ..runtime.io import atomic_write_npy

    models = list(model) if isinstance(model, (list, tuple)) else [model]
    start, end = _action_range(len(dataset.video_info), args.split,
                               args.total_split)
    if args.split != -1:
        # resume at the batch of the last file written (that file again: it
        # may be cut); batches stay where a whole run puts them, and with
        # them the seeds of their noise
        idx = start
        while idx < end and os.path.exists(os.path.join(save_root,
                                                        f"{idx:06d}.npy")):
            idx += 1
        start += max(idx - 1 - start, 0) // args.bs * args.bs
    dataset.vid_len = args.vid_len * dataset.fps
    dataset.simulator  # built once, before the loader's threads read it
    dataset.load_video, dataset.start_idx, dataset.end_idx = True, start, end
    loader = DataLoader(dataset, batch_size=args.bs, shuffle=False,
                        drop_last=False, num_workers=num_workers)
    written = 0
    with torch.inference_mode():
        for batch in loader:
            idxs = batch["data_idx"]

            def encode(_, m, lo, hi):
                device = m.init_latents.device
                gen = torch.Generator(device).manual_seed(int(idxs[0]))
                if hi - lo < len(idxs):
                    gen = RowShard(gen, len(idxs) // (hi - lo), lo // (hi - lo))
                vids = torch.from_numpy(batch["video"][lo:hi]).to(device)
                return m.encode(vids, generator=gen)[1].float()

            slots = spread_rows(encode, models, len(idxs))
            for k, i in enumerate(idxs):
                atomic_write_npy(slots[k, :int(batch["vid_len"][k])],
                                 os.path.join(save_root, f"{int(i):06d}.npy"))
            written += len(idxs)
            print(f"  {int(idxs[-1]) + 1}/{end}", flush=True)
    dataset.load_video, dataset.start_idx, dataset.end_idx = False, None, None
    return written


def main(argv=None) -> dict:
    """Returns ``{split: the directory of its slot files}``."""
    parser = argparse.ArgumentParser(description="extract PHYRE slots")
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True,
                        help="reference-format {'state_dict': ...} file")
    parser.add_argument("--save_path", required=True)
    parser.add_argument("--vid_len", type=int, default=11)
    parser.add_argument("--split", type=int, default=-1)
    parser.add_argument("--total_split", type=int, default=10)
    parser.add_argument("--bs", type=int, default=32)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..datasets import build_dataset
    from ..models import build_model
    from ..runtime import load_checkpoint, load_params, symlink_force

    params = load_params(args.params)
    model = build_model(params, device=args.device)
    model.load_state_dict(load_checkpoint(args.weight)["state_dict"])
    models = replicas(model, local_devices(args.device))
    train_set, val_set = build_dataset(params)
    stem = os.path.splitext(os.path.basename(args.params))[0]
    out = {}
    for name, ds in (("val", val_set), ("train", train_set)):
        save_root = os.path.join(
            args.save_path, "slots", stem,
            f"{ds.protocal}-fold_{ds.fold}-{ds.split}-data_{ds.ratio}-"
            f"pos_{ds.pos_ratio}")
        os.makedirs(save_root, exist_ok=True)
        if args.split in (-1, 0):
            symlink_force(save_root, os.path.join(
                os.path.dirname(os.path.abspath(args.weight)), f"{name}_slots"))
        print(f"[extract_phyre] split={name} actions={len(ds.video_info)}",
              flush=True)
        extract_phyre_video_slots(models, ds, save_root, args,
                                  int(params.get("num_workers", 4)))
        out[name] = save_root
    return out


if __name__ == "__main__":
    main()
