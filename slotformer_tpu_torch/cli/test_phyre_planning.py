"""PHYRE planning evaluation with AUCCESS, the port of
``slotformer_tpu/cli/test_phyre_planning.py``.

For each eval task of the fold and each of its ``--num_acts`` candidate
actions of the phyre 100k cache, the simulator renders frame 0 on the host;
then SAVi encodes it, SingleStepSlotFormer rolls out ``n_sample_frames - 1``
frames and the PHYREReadout scores the slots: ``score_actions``, one
function under ``torch.no_grad`` on the card, in batches of ``--bs`` valid
actions. The next batch renders on the host while the card scores the
last. Actions are ranked by confidence per task, and AUCCESS weighs the
successes of the first 100 attempts (invalid actions are left out).
``--split K --total_split N`` scores the K-th of N ranges of (task, action)
pairs and saves ``pred_conf-K.npy`` and ``gt_status-K.npy`` under ``test/``
beside the readout weight; ``--collect <that dir>`` merges the shards and
prints AUCCESS.

Usage:
    python -m slotformer_tpu_torch.cli.test_phyre_planning --params <sf_cfg.py> \
        --weight <sf.pth> --task_cls_params <readout_cfg.py> \
        --task_cls_weight <readout.pth> --savi_params <savi_cfg.py> \
        --savi_weight <savi.pth> [--split K --total_split N] [--bs 128]
    python -m slotformer_tpu_torch.cli.test_phyre_planning --collect <dir> \
        --total_split N
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..metrics.auccess import INVALID, auccess_from_conf
from .extract_phyre_slots import _action_range


def collect_results(save_path: str, total_split: int) -> float:
    """Merge the shards' tables into ``all_conf.npy`` / ``all_gt.npy``;
    returns AUCCESS."""
    conf0 = np.load(os.path.join(save_path, "pred_conf-0.npy"))
    gt0 = np.load(os.path.join(save_path, "gt_status-0.npy"))
    for split in range(1, total_split):
        conf = np.load(os.path.join(save_path, f"pred_conf-{split}.npy"))
        gt = np.load(os.path.join(save_path, f"gt_status-{split}.npy"))
        conf0[gt != -100] = conf[gt != -100]
        gt0[gt != -100] = gt[gt != -100]
    if (gt0 == -100).any() or (conf0 == -100).any():
        raise ValueError(f"the shards under {save_path} leave actions unscored")
    np.save(os.path.join(save_path, "all_conf.npy"), conf0)
    np.save(os.path.join(save_path, "all_gt.npy"), gt0)
    score, s = auccess_from_conf(conf0, gt0)
    print("Success rate in the first 100 attempts:\n", s)
    print(f"AUCCESS = {score:.2f}")
    return score


@torch.no_grad()
def score_actions(savi, sf, cls, frame0: torch.Tensor, rollout_len: int,
                  generator=None) -> torch.Tensor:
    """Success probabilities [B] of the first frames ``frame0`` [B, 1, H, W,
    3]: SAVi's slots, rolled out ``rollout_len`` frames, classified."""
    _, slots, _, _ = savi.encode(frame0, generator=generator)  # [B, 1, N, C]
    slots = torch.cat([slots, sf.rollout(slots, rollout_len)], dim=1)
    return torch.sigmoid(cls({"slots": slots})["logits"])


def main(argv=None):
    """Returns (AUCCESS after ``--collect`` or an unsharded run, else None;
    the run's counts, seconds and save path)."""
    parser = argparse.ArgumentParser(description="PHYRE planning eval")
    parser.add_argument("--params", default="")
    parser.add_argument("--weight", default="")
    parser.add_argument("--task_cls_params", default="")
    parser.add_argument("--task_cls_weight", default="")
    parser.add_argument("--savi_params", default="")
    parser.add_argument("--savi_weight", default="")
    parser.add_argument("--split", type=int, default=-1)
    parser.add_argument("--total_split", type=int, default=10)
    parser.add_argument("--bs", type=int, default=128)
    parser.add_argument("--num_acts", type=int, default=10000,
                        help="candidate actions per task (the reference's 10k)")
    parser.add_argument("--collect", default="", help="merge the shards' dir")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.collect:
        return collect_results(args.collect, args.total_split), {}

    from ..datasets.phyre import _fold_tasks, _require_phyre, observations_to_uint8_rgb
    from ..datasets.utils import BaseTransforms
    from ..models import build_model
    from ..runtime import load_checkpoint, load_params

    phyre = _require_phyre()
    device = torch.device(args.device)
    models = []
    for cfg, weight in ((args.savi_params, args.savi_weight),
                        (args.params, args.weight),
                        (args.task_cls_params, args.task_cls_weight)):
        m = build_model(load_params(cfg), device=device)
        m.load_state_dict(load_checkpoint(weight)["state_dict"])
        models.append(m)
    params = load_params(args.params)
    rollout_len = params.n_sample_frames - 1
    tf = BaseTransforms(params.resolution)
    reverse_color = params.get("reverse_color", False)

    tasks, eval_setup = _fold_tasks(phyre, params.phyre_protocal,
                                    params.phyre_fold, "val")
    simulator = phyre.initialize_simulator(
        tasks, phyre.eval_setup_to_action_tier(eval_setup))
    num_tasks, num_acts = len(tasks), args.num_acts
    cache = phyre.get_default_100k_cache("ball")
    act_lst = cache.action_array[:num_acts]
    statuses = np.array(cache.get_sample(tasks, None)["simulation_statuses"])

    pairs = [(t, a) for t in range(num_tasks) for a in range(num_acts)]
    lo, hi = _action_range(len(pairs), args.split, args.total_split)
    pairs = pairs[lo:hi]
    all_conf = np.full((num_tasks, num_acts), -100.0)
    all_gt = np.full((num_tasks, num_acts), -100.0)

    # invalid actions are recorded at once; the valid ones are scored in
    # batches of --bs
    valid = []
    for t_id, a_id in pairs:
        status = int(statuses[t_id, a_id])
        if status == INVALID:
            all_conf[t_id, a_id], all_gt[t_id, a_id] = -1.0, status
        else:
            valid.append((t_id, a_id, status))

    def render(chunk) -> torch.Tensor:
        """The first frames [B, 1, H, W, 3] of ``chunk``'s actions, on the
        card."""
        frames = []
        for t_id, a_id, _ in chunk:
            sim = simulator.simulate_action(
                t_id, act_lst[a_id], stride=60, need_images=True,
                need_featurized_objects=False)
            frames.append(tf(np.ascontiguousarray(
                observations_to_uint8_rgb(sim.images[0], reverse_color))))
        batch = np.stack(frames)[:, None].astype(np.float32)
        return torch.from_numpy(batch).to(device, non_blocking=True)

    def finish(conf, chunk):
        conf = conf.float().cpu().numpy()
        for k, (t_id, a_id, status) in enumerate(chunk):
            all_conf[t_id, a_id], all_gt[t_id, a_id] = conf[k], status

    t0, pending = time.perf_counter(), None
    for i0 in range(0, len(valid), args.bs):
        chunk = valid[i0:i0 + args.bs]
        frames = render(chunk)  # while the card scores the last batch
        if pending is not None:
            finish(*pending)
        gen = torch.Generator(device).manual_seed(0)
        pending = (score_actions(*models, frames, rollout_len, gen), chunk)
        print(f"  {min(i0 + args.bs, len(valid))}/{len(valid)}", flush=True)
    if pending is not None:
        finish(*pending)
    seconds = time.perf_counter() - t0

    save_path = os.path.join(
        os.path.dirname(os.path.abspath(args.task_cls_weight)), "test")
    os.makedirs(save_path, exist_ok=True)
    tag = max(args.split, 0)
    np.save(os.path.join(save_path, f"pred_conf-{tag}.npy"), all_conf)
    np.save(os.path.join(save_path, f"gt_status-{tag}.npy"), all_gt)
    print(f"[test_phyre_planning] shard saved -> {save_path}")
    stats = dict(pairs=len(pairs), scored=len(valid), seconds=seconds,
                 save_path=save_path)
    if args.split != -1:
        return None, stats
    score, _ = auccess_from_conf(all_conf, all_gt)
    print(f"AUCCESS = {score:.2f}")
    return score, stats


if __name__ == "__main__":
    main()
