"""Physion VQA readout evaluation, the port of
``slotformer_tpu/cli/test_physion_vqa.py``.

Every checkpoint (``--weight``: one ``.pth`` file, or a directory whose
``.pth`` files are swept, ``latest*`` left out) is scored on the test subset
(the rolled-out ``test_slots.pkl`` beside the config's ``slots_root``) at
every threshold of ``--threshs``: the accuracy overall and per task. The best
(checkpoint, threshold) is printed with its per-task accuracies. Reference
``.pth`` files and this package's checkpoints are read alike.

Usage:
    python -m slotformer_tpu_torch.cli.test_physion_vqa --params <readout_cfg.py> \
        --weight <ckpt.pth or dir> [--threshs 0.4 0.45 ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None) -> dict:
    """Returns ``{'sweep': [cell, ...], 'best': cell}``, a cell being
    ``{'weight', 'thresh', 'acc', 'task_acc': {task: acc}}``."""
    parser = argparse.ArgumentParser(description="test Physion VQA readout")
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True)
    parser.add_argument("--threshs", nargs="+", type=float,
                        default=[0.4, 0.45, 0.5, 0.55, 0.6, 0.65])
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from ..datasets import build_dataset
    from ..models import build_model
    from ..runtime import DataLoader, load_checkpoint, load_params

    params = load_params(args.params)
    params.dataset = "physion_slots_label_test"
    params.slots_root = os.path.join(os.path.dirname(params.slots_root),
                                     "test_slots.pkl")
    test_set = build_dataset(params)
    device = torch.device(args.device)
    model = build_model(params, device=device)

    if os.path.isfile(args.weight):
        all_weights = [args.weight]
    else:
        all_weights = [os.path.join(args.weight, w)
                       for w in sorted(os.listdir(args.weight))
                       if w.endswith(".pth") and not w.startswith("latest")]
    loader = DataLoader(test_set, batch_size=args.batch_size, shuffle=False,
                        drop_last=False,
                        num_workers=int(params.get("num_workers", 4)))

    def eval_weight(w):
        model.load_state_dict(load_checkpoint(w)["state_dict"])
        probs, labels, tasks = [], [], []
        with torch.no_grad():
            for batch in loader:
                slots = torch.from_numpy(batch["slots"]).to(device)
                probs.append(torch.sigmoid(
                    model({"slots": slots})["logits"].float()).cpu().numpy())
                labels.append(np.asarray(batch["label"]))
                tasks.append(np.asarray(batch["task_idx"]))
        return (np.concatenate(probs), np.concatenate(labels),
                np.concatenate(tasks))

    sweep, best = [], None
    for w in all_weights:
        probs, labels, tasks = eval_weight(w)
        for thresh in args.threshs:
            pred = (probs > thresh).astype(labels.dtype)
            cell = {"weight": os.path.basename(w), "thresh": thresh,
                    "acc": float((pred == labels).mean()),
                    "task_acc": {test_set.all_tasks[t]: float(
                        (pred[tasks == t] == labels[tasks == t]).mean())
                        for t in np.unique(tasks)}}
            print(f"{cell['weight']} @ {thresh:.2f}: acc={cell['acc']:.4f}")
            sweep.append(cell)
            if best is None or cell["acc"] > best["acc"]:
                best = cell

    print(f"\nThreshold {best['thresh']}, {best['weight']} achieves the best "
          "accuracy")
    print(f"All accuracy: {best['acc']:.3f}")
    for task, a in best["task_acc"].items():
        print(f"{task}: {a:.3f}")
    return {"sweep": sweep, "best": best}


if __name__ == "__main__":
    main()
