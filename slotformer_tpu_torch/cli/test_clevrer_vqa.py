"""CLEVRER VQA evaluation and submission CLI: the port of
``slotformer_tpu/cli/test_clevrer_vqa.py``.

    python -m slotformer_tpu_torch.cli.test_clevrer_vqa --params <cfg.py>
        --weight <ckpt.pth> [--split test|val] [--batch_size B]
        [--max_batches K] [--save_path CLEVRER.json] [--device cuda]

``--split test`` (the default) writes the eval.ai submission ``CLEVRER.json``
for the 5000 test scenes beside the weight (or at ``--save_path``):
descriptive questions get an answer string, multiple-choice questions a
correct/wrong verdict per choice (reference test_clevrer_vqa.py).
``--split val`` scores question-level accuracies instead: descriptive rows,
multiple-choice questions right only when every choice is, and each
multiple-choice subtype. ``--weight`` is a checkpoint of this package's
trainer or a reference ``.pth`` (``transformer_model.*`` keys).
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict

import numpy as np

_META = ("scene_index", "question_id", "choice_id", "q_subtype", "is_cls",
         "raw_label")


def _forward_rows(model, dataset, batch_size, device, max_batches=-1,
                  num_workers=4):
    """Yield (row metadata, descriptive answer class, choice predicted
    correct?) for every row of ``dataset``."""
    import torch

    from ..runtime import DataLoader

    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                        drop_last=False, num_workers=num_workers)
    for bi, batch in enumerate(loader):
        if 0 < max_batches <= bi:
            break
        db = {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
              for k in ("video_emb", "q_tokens", "q_pad_mask", "is_cls")}
        with torch.no_grad():
            out = model(db)
        cls_ans = out["cls_answer_logits"].argmax(-1).cpu().numpy()
        mc_pred = (out["mc_answer_logits"] > 0).cpu().numpy()
        for i in range(len(cls_ans)):
            yield ({k: batch[k][i] for k in _META}, int(cls_ans[i]),
                   bool(mc_pred[i]))


def main(argv=None):
    """Returns the submission list (``--split test``) or the question-level
    metrics (``--split val``)."""
    parser = argparse.ArgumentParser(description="Aloe CLEVRER VQA eval")
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True)
    parser.add_argument("--split", default="test", choices=["test", "val"])
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--max_batches", type=int, default=-1)
    parser.add_argument("--save_path", default="")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from ..datasets.clevrer_vqa import build_clevrer_vqa_dataset
    from ..methods import score_questions
    from ..models import build_model
    from ..runtime import dump_obj, load_checkpoint, load_params

    params = load_params(args.params)
    device = torch.device(args.device)
    model = build_model(params, device=device)
    model.load_state_dict(load_checkpoint(args.weight)["state_dict"])
    nw = int(params.get("num_workers", 4))

    if args.split == "test":
        dataset = build_clevrer_vqa_dataset(params, test_set=True)
        results = [{"scene_index": i + 15000, "questions": []} for i in range(5000)]
        mc_entries = {}
        for meta, cls_ans, mc_pred in _forward_rows(
                model, dataset, args.batch_size, device, args.max_batches, nw):
            scene = results[int(meta["scene_index"]) - 15000]
            q_id = int(meta["question_id"])
            if meta["is_cls"]:
                scene["questions"].append(
                    {"question_id": q_id,
                     "answer": str(dataset.label2answer[cls_ans])})
                continue
            key = (int(meta["scene_index"]), q_id)
            if key not in mc_entries:
                mc_entries[key] = {"question_id": q_id, "choices": []}
                scene["questions"].append(mc_entries[key])
            mc_entries[key]["choices"].append(
                {"choice_id": int(meta["choice_id"]),
                 "answer": "correct" if mc_pred else "wrong"})
        save_path = args.save_path or os.path.join(
            os.path.dirname(os.path.abspath(args.weight)), "CLEVRER.json")
        dump_obj(results, save_path)
        print(f"[test_clevrer_vqa] submission saved -> {save_path}")
        return results

    dataset = build_clevrer_vqa_dataset(params, val_only=True)
    cls_correct = cls_total = 0
    mc_rows = defaultdict(list)
    for meta, cls_ans, mc_pred in _forward_rows(
            model, dataset, args.batch_size, device, args.max_batches, nw):
        if meta["is_cls"]:
            cls_total += 1
            cls_correct += int(cls_ans == int(meta["raw_label"]))
        else:
            mc_rows[(int(meta["scene_index"]), int(meta["question_id"]))].append(
                (mc_pred == bool(meta["raw_label"]), int(meta["q_subtype"])))
    metrics = {"descriptive_acc": cls_correct / max(cls_total, 1),
               "descriptive_n": cls_total}
    for name, verdicts in score_questions(mc_rows).items():
        metrics[f"{name}_acc"] = float(np.mean(verdicts)) if verdicts else 0.0
        metrics[f"{name}_n"] = len(verdicts)
    for q in ("descriptive", "multiple-choice", "explanatory", "predictive",
              "counterfactual"):
        print(f"{q}_acc: {metrics[f'{q}_acc']:.4f} "
              f"({metrics[f'{q}_n']} questions)")
    return metrics


if __name__ == "__main__":
    main()
