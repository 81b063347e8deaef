"""Video-prediction evaluation CLI: the port of ``slotformer_tpu/cli/test_vp.py``.

    python -m slotformer_tpu_torch.cli.test_vp --params <cfg.py> --weight <ckpt>
        [--batch_size B] [--save_num N] [--lpips weights] [--vis_dir vis]
        [--max_batches K] [--device cuda]

Reference behaviour (video_prediction/test_vp.py):
  * per-dataset rollout length (OBJ3D 50, CLEVRER 48 frames); CLEVRER and the
    synthetic dataset also evaluate masks/bboxes (ARI/FG-ARI/mIoU/AR);
  * ``use_img_recon_loss`` and ``load_img`` are forced, so rollouts are
    decoded to pixels;
  * one AverageMeter per metric and rollout step; saves the per-metric
    ``.npy`` and the comparison/mask/bbox videos under
    ``<vis_dir>/<dataset>/<cfg>/``.

``--weight`` is a checkpoint of this program or a reference ``.pth``. The
forward (rollout + decode + mask post-processing) and the batched metrics run
on ``--device``; only the Hungarian and box matching run on the host. LPIPS
uses ``--lpips`` weights when given, else a seeded untrained VGG, flagged in
the output. ``--wire`` is accepted for parity with the JAX CLI, where
``uint8`` shrinks the transfer to a remote chip; the default here is ``f32``
(the ground truth is not quantised on its way to a local card).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

METRICS = ["mse", "psnr", "ssim", "percept_dist", "ari", "fari", "miou", "ar"]


def adjust_params(params, batch_size: int):
    if batch_size > 0:
        params.val_batch_size = batch_size
    else:
        params.val_batch_size = 12 if "obj3d" in params.dataset.lower() else 8
    ds = params.dataset.lower()
    if "obj3d" in ds:
        num_frames = 50
    elif "clevrer" in ds:
        num_frames = 48
        params.load_mask = True
    elif "synthetic" in ds:
        num_frames = params.get("video_len", 20)
        params.load_mask = True
    else:
        raise NotImplementedError(f"Unknown dataset: {params.dataset}")
    params.n_sample_frames = num_frames
    params.loss_dict["rollout_len"] = num_frames - params.input_frames
    params.loss_dict["use_img_recon_loss"] = True
    params.load_img = True
    # the evaluation consumes recon_combined + masks, which only the
    # pixel-decoding SlotFormer family produces (the reference's get_output
    # raises for anything else, test_vp.py:93-99)
    if params.model not in ("SlotFormer", "SingleStepSlotFormer"):
        raise NotImplementedError(
            f"test_vp needs a pixel-decoding model (recon_combined + masks); "
            f"got {params.model!r}")
    return params


def main(argv=None) -> dict:
    """Run the evaluation; returns its timing and trajectory statistics (None
    with ``--save_num``, which only writes videos)."""
    parser = argparse.ArgumentParser(description="evaluate video prediction")
    parser.add_argument("--params", required=True)
    parser.add_argument("--weight", required=True)
    parser.add_argument("--batch_size", type=int, default=-1)
    parser.add_argument("--save_num", type=int, default=-1)
    parser.add_argument("--lpips", default="", help="LPIPS weights file")
    parser.add_argument("--vis_dir", default="vis")
    parser.add_argument("--max_batches", type=int, default=-1)
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--wire", choices=("uint8", "f32"), default="f32",
        help="format of the GT images handed to the metrics (uint8 quantises "
        "float-rendered GT by <= 1/255; kept for parity with the JAX CLI)")
    args = parser.parse_args(argv)

    import torch

    from ..datasets import build_dataset
    from ..metrics import load_lpips, masks_to_boxes, postproc_mask, pred_eval_step
    from ..metrics.vis import batch_draw_bbox, colorize_mask, make_video
    from ..models import build_model
    from ..runtime import (
        AverageMeter,
        BaseDataModule,
        load_checkpoint,
        load_params,
        mkdir_or_exist,
        save_video,
    )

    params = load_params(args.params)
    params = adjust_params(params, args.batch_size)
    cfg_name = os.path.splitext(os.path.basename(args.params))[0]
    device = torch.device(args.device)
    on_cuda = device.type == "cuda"

    val_set = build_dataset(params, val_only=True)
    datamodule = BaseDataModule(params, train_set=None, val_set=val_set)
    val_loader = datamodule.val_loader

    model = build_model(params, device=device)
    model.load_state_dict(load_checkpoint(args.weight)["state_dict"])

    lpips_fn = load_lpips(args.lpips, fallback="untrained", device=device)
    if lpips_fn.source != "file":
        print(
            "[test_vp] " + "!" * 62 + "\n"
            "[test_vp] !! no LPIPS weights file: percept_dist uses a seeded\n"
            "[test_vp] !! UNTRAINED VGG (meaningful but NOT paper-comparable;\n"
            "[test_vp] !! LPIPS paper section 5). Pass converted official\n"
            "[test_vp] !! weights with --lpips <file>.\n"
            "[test_vp] " + "!" * 62
        )

    history_len = params.input_frames
    rollout_len = params.n_sample_frames - history_len
    eval_traj = params.get("load_mask", False)
    num_slots = params.slot_dict["num_slots"]
    # mask ids are bounded by the dataset's object cap (background id 0 +
    # max_n_objects); prefer the dataset's own cap
    max_mask_ids = 1 + int(
        getattr(val_set, "max_n_objects",
                params.get("max_n_objects",
                           params.get("num_objects", num_slots - 1))))
    num_classes = max(num_slots, max_mask_ids)

    @torch.no_grad()
    def forward(slots):
        out = model({"slots": slots})
        pred_mask = postproc_mask(out["masks"])  # [B, T_ro, N, H, W, 1] -> ids
        pred_bbox = masks_to_boxes(pred_mask, num_slots)
        return out["recon_combined"], pred_mask, pred_bbox

    def sync():
        if on_cuda:
            torch.cuda.synchronize(device)

    meters = {m: [AverageMeter() for _ in range(rollout_len)] for m in METRICS}
    traj_stats = {"batches": 0, "gt_ids_max": 0, "pred_ids_max": 0}
    save_videos, save_mask_videos, save_bbox_videos = [], [], []
    video_num = 10 if args.save_num <= 0 else args.save_num
    only_vis = args.save_num > 0

    # wall-clock accounting: total includes data loading and the host-side
    # videos; fwd = rollout + decode + mask post-processing, metrics =
    # pred_eval_step, each between device synchronisations. The first batch
    # is reported apart as warm-up (cuDNN algorithm choice, allocator).
    t_fwd = t_metrics = t_first = 0.0
    eval_frames = 0
    t_start = time.perf_counter()

    for bi, batch in enumerate(val_loader):
        if args.max_batches > 0 and bi >= args.max_batches:
            break
        db = {k: v for k, v in batch.items() if hasattr(v, "shape")}
        gt = db["img"][:, history_len:]
        B = gt.shape[0]
        if args.wire == "uint8":
            gt = ((gt + 1.0) * 127.5).round().clip(0, 255).astype(np.uint8)
        gt_mask = db["mask"][:, history_len:].astype(np.int32) if "mask" in db else None
        gt_bbox = db["bbox"][:, history_len:] if "bbox" in db else None
        gt_pres = (db["pres_mask"][:, history_len:].astype(bool)
                   if "pres_mask" in db else None)

        sync()
        t0 = time.perf_counter()
        # only the slots go through the model; GT images and masks are
        # inputs of the metrics
        pred, pred_mask, pred_bbox = forward(
            torch.from_numpy(np.ascontiguousarray(db["slots"])).to(device))
        sync()
        t1 = time.perf_counter()

        traj = bool(eval_traj) and gt_mask is not None
        if traj:
            traj_stats["batches"] += 1
            traj_stats["gt_ids_max"] = max(traj_stats["gt_ids_max"], int(gt_mask.max()))
            traj_stats["pred_ids_max"] = max(
                traj_stats["pred_ids_max"], int(pred_mask.max()))
            assert traj_stats["gt_ids_max"] < num_classes, (
                f"gt mask id {traj_stats['gt_ids_max']} exceeds the dataset "
                f"object cap ({num_classes=}): fix params.max_n_objects")
        md = pred_eval_step(
            gt=gt,
            pred=pred,
            lpips_fn=lpips_fn,
            gt_mask=gt_mask if traj else None,
            pred_mask=pred_mask if traj else None,
            gt_pres_mask=gt_pres if traj else None,
            gt_bbox=gt_bbox if traj else None,
            pred_bbox=pred_bbox if traj else None,
            eval_traj=traj,
            num_classes=num_classes if traj else None,
        )
        for i in range(rollout_len):
            for m in METRICS:
                meters[m][i].update(md[m][i], B)
        sync()
        t2 = time.perf_counter()
        if bi == 0:
            t_first = t2 - t0
        else:
            t_fwd += t1 - t0
            t_metrics += t2 - t1
            eval_frames += B * rollout_len

        flag = False
        pred_h = pred_mask_h = pred_bbox_h = None
        for i in range(B):
            if len(save_videos) >= video_num:
                flag = only_vis
                break
            if pred_h is None:
                # host copies only for the batches that give videos
                pred_h = pred.cpu().numpy()
                pred_mask_h = pred_mask.cpu().numpy()
                pred_bbox_h = pred_bbox.cpu().numpy()
            gt_video = db["img"][i]
            pred_video = np.concatenate([gt_video[:history_len], pred_h[i]], 0)
            save_videos.append(make_video(gt_video, pred_video, history_len))
            if not traj:
                continue
            gmv = colorize_mask(db["mask"][i])
            pmv = colorize_mask(
                np.concatenate([db["mask"][i][:history_len], pred_mask_h[i]], 0))
            save_mask_videos.append(np.concatenate([gmv, pmv], axis=1))
            gt_bbox_vid = batch_draw_bbox(gt_video, db["bbox"][i], db["pres_mask"][i])
            # pad/trim the gt boxes to num_slots so that the history's and
            # the rollout's boxes concatenate
            gt_b = db["bbox"][i][:history_len, :num_slots]
            if gt_b.shape[1] < num_slots:
                fill = -np.ones(
                    (gt_b.shape[0], num_slots - gt_b.shape[1], 4), np.float32)
                gt_b = np.concatenate([gt_b, fill], axis=1)
            pred_bbox_all = np.concatenate([gt_b, pred_bbox_h[i]], 0)
            pd_bbox_vid = batch_draw_bbox(pred_video, pred_bbox_all)
            save_bbox_videos.append(make_video(gt_bbox_vid, pd_bbox_vid, history_len))
        if flag:
            break
        print(f"[test_vp] batch {bi + 1}/{len(val_loader)}", flush=True)

    save_dir = os.path.join(args.vis_dir, params.dataset.split("_")[0], cfg_name)
    mkdir_or_exist(save_dir)
    if save_videos:
        save_video(np.concatenate(save_videos, axis=2),
                   os.path.join(save_dir, f"{cfg_name}.mp4"), fps=4)
        if save_mask_videos:
            save_video(np.concatenate(save_mask_videos, axis=2),
                       os.path.join(save_dir, f"{cfg_name}_mask.mp4"), fps=4)
            save_video(
                np.concatenate(
                    [np.clip(v * 0.5 + 0.5, 0, 1) for v in save_bbox_videos], axis=2),
                os.path.join(save_dir, f"{cfg_name}_bbox.mp4"), fps=4)
    if only_vis:
        return None

    t_total = time.perf_counter() - t_start
    t_steady = t_fwd + t_metrics
    print(
        f"[test_vp] wall-clock: total={t_total:.1f}s "
        f"first_batch={t_first:.1f}s (warm-up) | steady-state "
        f"fwd={t_fwd:.1f}s metrics={t_metrics:.1f}s over {eval_frames} "
        f"rollout frames"
        + (f" -> {eval_frames / t_steady:.0f} f/s with metrics, "
           f"{eval_frames / t_fwd:.0f} f/s fwd-only"
           if t_steady > 0 and t_fwd > 0 else "")
    )

    results = {m: np.array([mm.avg for mm in v]) for m, v in meters.items()}
    if args.wire == "uint8":
        print("[test_vp] note: gt quantized (uint8 wire): pixel metrics "
              "not bit-comparable to f32-wire evals on float-rendered data")
    for k, v in results.items():
        np.save(os.path.join(save_dir, f"{k}.npy"), v)
        print(f"{k}: {v.mean():.4f}")
    # say whether the trajectory-metric path really ran: ari == 0 is also
    # the zero fill of eval_traj=False
    print(
        f"[test_vp] eval_traj={eval_traj} traj_batches={traj_stats['batches']} "
        f"gt_mask_ids_max={traj_stats['gt_ids_max']} "
        f"pred_mask_ids_max={traj_stats['pred_ids_max']} "
        f"percept_dist_source={lpips_fn.source}"
    )
    if eval_traj and traj_stats["batches"] == 0:
        print("[test_vp] WARNING: eval_traj requested but no batch had masks")
    if traj_stats["batches"] and results["ari"].mean() == 0.0:
        print("[test_vp] WARNING: trajectory path ran but ARI == 0 exactly -- "
              "model at chance or mask pipeline broken")
    return dict(save_dir=save_dir, results=results, traj=traj_stats,
                percept_dist_source=lpips_fn.source, seconds_total=t_total,
                seconds_first_batch=t_first, seconds_fwd=t_fwd,
                seconds_metrics=t_metrics, steady_frames=eval_frames)


if __name__ == "__main__":
    main()
