"""Offline slot extraction: a frozen StoSAVi or STEVE encoder over whole
videos.

The port of ``slotformer_tpu/cli/extract_slots.py``. Every video of each
split is encoded to slots and ONE pickle ``{split: {video_basename: float32
[T, N, C]}}`` is written and symlinked next to the weight file. For Physion,
``--subset`` picks the dataset subset (training | readout | test), the
default save path names it, and the link is ``{subset}_slots.pkl``, the
name ``cli/rollout_slots.py --task physion`` looks for.

Videos are batched (``--batch_size``) and encoded in chunks of ``--chunk_len``
frames with slot carry-over; a short tail chunk is padded to ``chunk_len``
by repeating its last frame (the padded frames' slots are dropped), so every
chunk has the same shape. With ``--device cuda`` a batch's videos are spread
over every visible card, one replica of the model on each (the rows do not
divide the cards: every card encodes all of them), and the slots are those
of one card: each replica draws the whole batch's noise and keeps its rows.

Usage:
    python -m slotformer_tpu_torch.cli.extract_slots --params <cfg.py> \
        --weight <ckpt.pth> [--save_path slots.pkl] [--chunk_len 24] \
        [--subset training]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from ..parallel.mesh import RowShard, local_devices, replicas, spread_rows
from ..trace import span


def extract_video_slots(model, dataset, batch_size: int, chunk_len: int,
                        seed: int = 0) -> Dict[str, np.ndarray]:
    """Encode every video of ``dataset`` (``files`` + ``get_video``) with
    ``model`` (StoSAVi or STEVE) on its device, or with a list of its
    replicas (``parallel.replicas``) over theirs; StoSAVi's kernel noise
    comes from a generator seeded with ``seed`` (one a replica). Returns
    {video_basename: [T, N, C] float32}."""
    from ..models import STEVE

    models = list(model) if isinstance(model, (list, tuple)) else [model]
    gens = [torch.Generator(device=m.init_latents.device).manual_seed(seed)
            for m in models]
    dataset.load_video = True
    out: Dict[str, np.ndarray] = {}
    names = [os.path.basename(f) for f in dataset.files]
    n_videos = len(names)
    with torch.inference_mode():
        for i in range(0, n_videos, batch_size):
            idxs = range(i, min(i + batch_size, n_videos))
            with span("extract.load"):
                vids = [dataset.get_video(j)["video"] for j in idxs]
                # the reference datasets have one length per split; trim
                # anyway
                T = min(v.shape[0] for v in vids)
                videos = np.stack([v[:T] for v in vids]).astype(np.float32)

            def encode(r, m, lo, hi):
                gen = gens[r] if hi - lo == len(videos) else RowShard(
                    gens[r], len(videos) // (hi - lo), lo // (hi - lo))
                batch = torch.from_numpy(videos[lo:hi]).to(m.init_latents.device)
                all_slots, carry = [], None
                for c0 in range(0, T, chunk_len):
                    chunk = batch[:, c0:c0 + chunk_len]
                    pad = chunk_len - chunk.shape[1] if c0 > 0 else 0
                    if pad:
                        chunk = torch.cat(
                            [chunk, chunk[:, -1:].expand(-1, pad, -1, -1, -1)], 1)
                    prev = (None, None) if carry is None else carry
                    if isinstance(m, STEVE):
                        slots, _, _, carry = m.encode(chunk, *prev)
                    else:
                        _, slots, _, carry = m.encode(chunk, *prev, generator=gen)
                    all_slots.append(slots[:, :slots.shape[1] - pad])
                return torch.cat(all_slots, 1)  # [b, T, N, C]

            slots = spread_rows(encode, models, len(videos))
            for k, j in enumerate(idxs):
                out[names[j]] = slots[k].astype(np.float32)
            if (i // batch_size + 1) % 10 == 0:
                print(f"  {min(i + batch_size, n_videos)}/{n_videos} videos",
                      flush=True)
    dataset.load_video = False
    return out


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="extract slots from videos")
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True,
                        help="reference-format {'state_dict': ...} file")
    parser.add_argument("--save_path", default="", help="output .pkl path")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--chunk_len", type=int, default=24)
    parser.add_argument("--subset", default="",
                        help="physion: the dataset subset, training | "
                             "readout | test (default training); otherwise "
                             "one split to extract (train|val, or test for "
                             "clevrer)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..datasets import build_dataset
    from ..models import build_model
    from ..runtime import dump_obj, load_params, symlink_force
    from ..runtime.checkpoint import load_checkpoint

    params = load_params(args.params)
    params.load_mask = False
    physion = params.dataset.startswith("physion")
    subset = None
    if physion:
        subset = args.subset or "training"
        if subset not in ("training", "readout", "test"):
            raise ValueError(f"physion --subset must be training|readout|test, "
                             f"got {subset!r}")
        params.dataset = f"physion_{subset}"
    model = build_model(params, device=args.device)
    model.load_state_dict(load_checkpoint(args.weight)["state_dict"])
    models = replicas(model, local_devices(args.device))

    save_path = args.save_path
    if not save_path:
        stem = os.path.splitext(os.path.basename(args.params))[0]
        stem = stem.replace("_params", "") + (f"_{subset}" if physion else "")
        save_path = os.path.join("data", f"{stem}_slots.pkl")
    elif physion and subset not in save_path:
        raise ValueError("name the physion subset in --save_path, to tell the "
                         "slot files apart")

    if subset == "test":  # the test subset has one split
        splits = {"test": build_dataset(params)}
    else:
        train_set, val_set = build_dataset(params)
        splits = {"train": train_set, "val": val_set}
    if params.dataset == "clevrer":
        from ..datasets.clevrer import build_clevrer_dataset

        splits["test"] = build_clevrer_dataset(params, test_set=True)
    if args.subset and not physion:
        splits = {args.subset: splits[args.subset]}

    out = {}
    for split, ds in splits.items():
        print(f"[extract] split={split} videos={len(ds.files)}", flush=True)
        out[split] = extract_video_slots(models, ds, args.batch_size,
                                         args.chunk_len, args.seed)
    dump_obj(out, save_path)
    print(f"[extract] saved -> {save_path}", flush=True)
    link_name = f"{subset}_slots.pkl" if physion else os.path.basename(save_path)
    link = os.path.join(os.path.dirname(os.path.abspath(args.weight)), link_name)
    symlink_force(save_path, link)
    return save_path


if __name__ == "__main__":
    main()
