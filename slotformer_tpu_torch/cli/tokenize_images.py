"""Dump dVAE tokens for every video of a Physion subset to a mirrored
``.npy`` tree, the port of ``slotformer_tpu/cli/tokenize_images.py``.

Every frame of each video (val split first, then train) is tokenized with
the frozen dVAE, in batches of ``--batch_size`` frames (the last batch
padded by repeating its last frame), and the ``[T, h*w]`` int32 ids are
written to the video's token path (``datasets.physion.token_path``:
``TrainMP4s/`` -> ``TrainNpys-$dvae/``, where ``$dvae`` is the config file's
name), the files ``PhysionDataset`` reads back. Files already written are
skipped, so a killed job restarts where it stopped.

Usage:
    python -m slotformer_tpu_torch.cli.tokenize_images \
        --params <dvae_cfg.py> --weight <dvae_ckpt.pth> [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def tokenize_videos(model, dataset, dvae_name: str, batch_size: int) -> dict:
    """Write the token file of every video of ``dataset`` that lacks one,
    with the dVAE ``model`` on its device. Returns the counts of videos
    written and skipped and of frames tokenized."""
    from ..datasets.physion import token_path
    from ..runtime.io import atomic_write_npy

    device = next(model.parameters()).device
    stats = dict(written=0, skipped=0, frames=0)
    dataset.load_video = True
    try:
        for vi, folder in enumerate(dataset.files):
            out_path = token_path(folder, dvae_name)
            if os.path.exists(out_path):
                stats["skipped"] += 1
                continue
            video = dataset.get_video(vi)["video"]  # [T, H, W, 3]
            toks = []
            for b0 in range(0, video.shape[0], batch_size):
                chunk = video[b0:b0 + batch_size]
                n = chunk.shape[0]
                if n < batch_size:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], batch_size - n, axis=0)])
                with torch.inference_mode():
                    ids = model.tokenize(torch.from_numpy(chunk).to(device),
                                         one_hot=False)
                toks.append(ids.reshape(batch_size, -1)[:n].cpu().numpy())
            atomic_write_npy(np.concatenate(toks).astype(np.int32), out_path)
            stats["written"] += 1
            stats["frames"] += video.shape[0]
            if (vi + 1) % 20 == 0:
                print(f"  {vi + 1}/{len(dataset.files)}", flush=True)
    finally:
        dataset.load_video = False
    return stats


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="dump dVAE tokens")
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True,
                        help="reference-format {'state_dict': ...} file")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..datasets import build_dataset
    from ..models import build_model
    from ..runtime import load_params
    from ..runtime.checkpoint import load_checkpoint

    params = load_params(args.params)
    model = build_model(params, device=args.device)
    model.load_state_dict(load_checkpoint(args.weight)["state_dict"])
    dvae_name = os.path.splitext(os.path.basename(args.params))[0]

    train_set, val_set = build_dataset(params)
    stats = {}
    for name, ds in (("val", val_set), ("train", train_set)):
        print(f"[tokenize] split={name} videos={len(ds.files)}", flush=True)
        stats[name] = tokenize_videos(model, ds, dvae_name, args.batch_size)
    return stats


if __name__ == "__main__":
    main()
