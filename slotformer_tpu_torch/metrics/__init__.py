"""Evaluation metrics of the port: video-prediction and object-centric
metrics, LPIPS, PHYRE's AUCCESS, and the visualisation helpers of the eval
CLIs."""

from .auccess import auccess_from_conf
from .lpips import load_lpips, untrained_lpips_weights
from .vp_metrics import (
    ARI_metric,
    PALETTE,
    PALETTE_np,
    adjusted_rand_index,
    batch_bbox_precision_recall,
    bbox_precision_recall,
    box_iou,
    fARI_metric,
    hungarian_miou_from_table,
    masks_to_boxes,
    miou_metric,
    mse_metric,
    pairwise_iou_tables,
    postproc_mask,
    pred_eval_step,
    psnr_metric,
    ssim_metric,
    to_rgb_from_tensor,
)

__all__ = [
    "auccess_from_conf",
    "load_lpips",
    "untrained_lpips_weights",
    "ARI_metric",
    "PALETTE",
    "PALETTE_np",
    "adjusted_rand_index",
    "batch_bbox_precision_recall",
    "bbox_precision_recall",
    "box_iou",
    "fARI_metric",
    "hungarian_miou_from_table",
    "masks_to_boxes",
    "miou_metric",
    "mse_metric",
    "pairwise_iou_tables",
    "postproc_mask",
    "pred_eval_step",
    "psnr_metric",
    "ssim_metric",
    "to_rgb_from_tensor",
]
