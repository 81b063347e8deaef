"""Video-prediction and object-centric evaluation metrics: the port of
``slotformer_tpu/metrics/vp_metrics.py``.

``postproc_mask`` (background-aware argmax), ``masks_to_boxes`` (empty masks
give -1), video-prediction MSE (summed over the spatial dims), per-frame
PSNR/SSIM (skimage conventions: gaussian weights, sigma 1.5, no sample
covariance, data_range 255), ARI/FG-ARI (the slot-attention-video formula),
Hungarian-matched mIoU with the undetected-object penalty, bbox
precision/recall at IoU 0.5, and the per-timestep aggregator
``pred_eval_step``.

Plain functions on tensors. Whatever is batched (MSE, PSNR, SSIM, ARI, the
pairwise IoU tables) runs on the device of its inputs over all timesteps at
once, and ``pred_eval_step`` brings the results to the host in one transfer;
only the small Hungarian assignment (scipy, at most 8x8) and the greedy box
matching run on the host, on numpy arrays. Functions that take numpy arrays
accept a ``device`` to compute on (default: the CPU).

Images are NHWC [B, T, H, W, C] in [-1, 1]. The clustering metrics count in
float32, as the JAX package does with x64 off.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

FG_THRE = 0.5

PALETTE = [(0, 255, 0), (0, 0, 255), (0, 255, 255), (255, 255, 0),
           (255, 0, 255), (100, 100, 255), (200, 200, 100), (170, 120, 200),
           (255, 0, 0), (200, 100, 100), (10, 200, 100), (200, 200, 200),
           (50, 50, 50)]
PALETTE_np = np.array(PALETTE, dtype=np.uint8)


def _tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor stays where it is unless ``device`` is
    given; anything else goes to ``device`` (default: the CPU)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def to_rgb_from_tensor(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)


def _one_hot(ids: torch.Tensor, num_classes: int) -> torch.Tensor:
    """float32 one-hot over a new last axis; an id outside
    [0, num_classes) gives an all-zero row (``jax.nn.one_hot``'s behaviour;
    ``F.one_hot`` raises)."""
    classes = torch.arange(num_classes, device=ids.device)
    return (ids.unsqueeze(-1) == classes).float()


# ---------------------------------------------------------------------------
# mask post-processing
# ---------------------------------------------------------------------------

def postproc_mask(batch_masks, device=None) -> torch.Tensor:
    """[B, T, N, H, W, 1] soft masks -> [B, T, H, W] int32 ids.

    Background-aware argmax (vp_utils.py:20-41): the slot whose largest
    activation is smallest is the background; pixels where no slot exceeds
    FG_THRE go to that slot. Ties take the first index.
    """
    batch_masks = _tensor(batch_masks, device)
    B, T, N, H, W, _ = batch_masks.shape
    m = batch_masks.reshape(B * T, N, H * W)
    bg_idx = m.amax(-1).argmin(-1)  # [BT]
    bg_pixels = m.amax(1) < FG_THRE  # [BT, HW]
    is_bg_slot = _one_hot(bg_idx, N).bool()  # [BT, N]
    boost = is_bg_slot[:, :, None] & bg_pixels[:, None, :]
    m = torch.where(boost, torch.ones_like(m), m)
    return m.argmax(1).reshape(B, T, H, W).to(torch.int32)


def masks_to_boxes(masks, num_boxes: int = 7, device=None) -> torch.Tensor:
    """[B, T, H, W] int masks -> [B, T, num_boxes, 4] xyxy float32; an id
    with no pixel gives -1 (vp_utils.py:44-69)."""
    masks = _tensor(masks, device)
    B, T, H, W = masks.shape
    oh = _one_hot(masks, num_boxes) > 0  # [B, T, H, W, N]
    ys = torch.arange(H, dtype=torch.float32, device=masks.device)[:, None, None]
    xs = torch.arange(W, dtype=torch.float32, device=masks.device)[None, :, None]
    big = 1e9
    x1 = torch.where(oh, xs, big).amin(dim=(2, 3))
    y1 = torch.where(oh, ys, big).amin(dim=(2, 3))
    x2 = torch.where(oh, xs, -big).amax(dim=(2, 3))
    y2 = torch.where(oh, ys, -big).amax(dim=(2, 3))
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)  # [B, T, N, 4]
    empty = ~oh.any(dim=3).any(dim=2)  # [B, T, N]
    return torch.where(empty[..., None], -torch.ones_like(boxes), boxes)


# ---------------------------------------------------------------------------
# pixel metrics
# ---------------------------------------------------------------------------

def mse_metric(x, y, device=None) -> torch.Tensor:
    """[B, H, W, C] in [0, 1]; the video-prediction convention: SUM over the
    spatial dims, mean over batch and channels (vp_utils.py:72-76)."""
    x, y = _tensor(x, device), _tensor(y, device)
    return ((x - y) ** 2).sum(dim=(1, 2)).mean()


def psnr_metric(x, y, device=None) -> torch.Tensor:
    """[B, H, W, C] in [0, 1]; per-sample PSNR (data_range 1), mean. The MSE
    is clamped at 1e-12."""
    x, y = _tensor(x, device), _tensor(y, device)
    mse = ((x - y) ** 2).mean(dim=(1, 2, 3))
    return (-10.0 * torch.log10(torch.clamp(mse, min=1e-12))).mean()


def _gaussian_kernel1d(sigma: float = 1.5, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _gauss_filter(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """Separable depthwise gaussian filter, VALID padding. img [B, C, H, W]."""
    C = img.shape[1]
    kh = kern.reshape(1, 1, -1, 1).expand(C, 1, -1, 1)
    kw = kern.reshape(1, 1, 1, -1).expand(C, 1, 1, -1)
    return F.conv2d(F.conv2d(img, kh, groups=C), kw, groups=C)


def _ssim_map(x: torch.Tensor, y: torch.Tensor,
              data_range: float) -> torch.Tensor:
    """The SSIM map of x, y [B, C, H, W] in [0, data_range] (VALID: the map
    is smaller than the images by the filter's radius on every side)."""
    kern = torch.from_numpy(_gaussian_kernel1d()).to(x.device)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    # the five filtered maps in one pass
    ux, uy, uxx, uyy, uxy = _gauss_filter(
        torch.cat([x, y, x * x, y * y, x * y]), kern).split(x.shape[0])
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    A1 = 2.0 * ux * uy + C1
    A2 = 2.0 * vxy + C2
    B1 = ux * ux + uy * uy + C1
    B2 = vx + vy + C2
    return (A1 * A2) / (B1 * B2)


def ssim_metric(x, y, data_range: float = 255.0, device=None) -> torch.Tensor:
    """[B, H, W, C] in [0, 1] -> mean SSIM, skimage conventions
    (gaussian_weights=True, sigma=1.5, use_sample_covariance=False,
    data_range=255 on inputs scaled by 255; vp_utils.py:91-106)."""
    x = _tensor(x, device).permute(0, 3, 1, 2) * 255.0
    y = _tensor(y, device).permute(0, 3, 1, 2) * 255.0
    return _ssim_map(x, y, data_range).mean()


# ---------------------------------------------------------------------------
# clustering metrics
# ---------------------------------------------------------------------------

def adjusted_rand_index(true_ids, pred_ids, num_classes: int,
                        ignore_background: bool = False,
                        device=None) -> torch.Tensor:
    """ARI over [B, T, H, W] (or [B, H, W]) int id maps -> [B] float32
    scores (the slot-attention-video formula, vp_utils.py:114-163); 1.0
    where the formula's denominator is 0."""
    true_ids, pred_ids = _tensor(true_ids, device), _tensor(pred_ids, device)
    if true_ids.ndim == 3:
        true_ids = true_ids[:, None]
    if pred_ids.ndim == 3:
        pred_ids = pred_ids[:, None]
    B = true_ids.shape[0]
    true_oh = _one_hot(true_ids.reshape(B, -1), num_classes)
    pred_oh = _one_hot(pred_ids.reshape(B, -1), num_classes)
    if ignore_background:
        true_oh = true_oh[..., 1:]
    N = torch.einsum("bpc,bpk->bck", true_oh, pred_oh)
    A = N.sum(-1)
    Bc = N.sum(-2)
    num_points = A.sum(1)
    rindex = (N * (N - 1)).sum(dim=(1, 2))
    aindex = (A * (A - 1)).sum(1)
    bindex = (Bc * (Bc - 1)).sum(1)
    expected = aindex * bindex / torch.clamp(num_points * (num_points - 1), min=1)
    max_rindex = (aindex + bindex) / 2
    denom = max_rindex - expected
    ari = (rindex - expected) / denom
    return torch.where(denom != 0, ari, torch.ones_like(ari))


def _check_int(*arrays) -> None:
    for a in arrays:
        dtype = a.dtype if isinstance(a, torch.Tensor) else np.asarray(a).dtype
        assert "int" in str(dtype), f"integer id maps expected, got {dtype}"


def ARI_metric(x, y, num_classes: int, device=None) -> float:
    _check_int(x, y)
    return float(adjusted_rand_index(x, y, num_classes, device=device).mean())


def fARI_metric(x, y, num_classes: int, device=None) -> float:
    _check_int(x, y)
    return float(adjusted_rand_index(x, y, num_classes, ignore_background=True,
                                     device=device).mean())


# ---------------------------------------------------------------------------
# Hungarian-matched mIoU
# ---------------------------------------------------------------------------

def pairwise_iou_tables(gt_mask, pred_mask, n_gt: int, n_pred: int,
                        device=None) -> torch.Tensor:
    """[B, HW] int masks -> [B, n_gt-1, n_pred] IoU tables (gt foreground
    classes only; gt id 0 is the background). An id >= its class count
    falls in no class. The Hungarian matching runs on the host over these
    small tables."""
    gt_mask, pred_mask = _tensor(gt_mask, device), _tensor(pred_mask, device)
    true_oh = _one_hot(gt_mask, n_gt)[..., 1:]
    pred_oh = _one_hot(pred_mask, n_pred)
    intersect = torch.einsum("bpn,bpm->bnm", true_oh, pred_oh)
    union = true_oh.sum(1)[:, :, None] + pred_oh.sum(1)[:, None, :] - intersect
    return intersect / (union + 1e-8)


def hungarian_miou_from_table(iou: np.ndarray, n_eff: int) -> float:
    """One sample: iou [n_gt_fg, n_pred]; ``n_eff`` = this sample's largest
    gt id (the reference's per-sample ``F.one_hot(gt)[..., 1:]`` row count,
    vp_utils.py:227-229). Rows are gt ids 1..n_eff: an id absent from the
    sample but below the largest still counts as an undetected object (an
    IoU-0 row), as in the reference; the sum is always divided by n_eff.
    An all-background gt scores 1.0 (the reference gives nan there)."""
    iou = np.asarray(iou)[:n_eff]
    N = iou.shape[0]
    if N == 0:
        return 1.0
    row, col = linear_sum_assignment(iou, maximize=True)
    return float(iou[row, col].sum() / N)


def miou_metric(gt_mask, pred_mask, n_gt: int, n_pred: int,
                device=None) -> float:
    """[B, H, W] int masks -> mean Hungarian-matched IoU."""
    gm = _tensor(gt_mask, device).flatten(1)
    pm = _tensor(pred_mask, device).flatten(1)
    tables = pairwise_iou_tables(gm, pm, n_gt, n_pred).cpu().numpy()
    n_eff = gm.amax(1).cpu().numpy()
    return float(np.mean([hungarian_miou_from_table(t, int(n))
                          for t, n in zip(tables, n_eff)]))


# ---------------------------------------------------------------------------
# bbox precision / recall (host, numpy)
# ---------------------------------------------------------------------------

def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 4] x [M, 4] xyxy -> [N, M] IoU."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-8)


def bbox_precision_recall(gt_pres_mask, gt_bbox, pred_bbox, ovthresh=0.5):
    """Greedy best-IoU matching per gt box (vp_utils.py:180-211)."""
    gt_bbox = np.asarray(gt_bbox)[np.asarray(gt_pres_mask, bool)]
    pred_bbox = np.asarray(pred_bbox)
    pred_bbox = pred_bbox[pred_bbox[:, 0] >= 0.0]
    N, M = gt_bbox.shape[0], pred_bbox.shape[0]
    if N == 0:
        # nothing to detect: perfect recall; spurious boxes cost precision
        return (1.0, 1.0) if M == 0 else (0.0, 1.0)
    if M == 0:
        return 0.0, 0.0
    tp = 0
    used = [False] * M
    ious = box_iou(gt_bbox, pred_bbox)
    for i in range(N):
        j = int(ious[i].argmax())
        if ious[i, j] >= ovthresh and not used[j]:
            tp += 1
            used[j] = True
    return tp / float(M), tp / float(N)


def batch_bbox_precision_recall(gt_pres_mask, gt_bbox, pred_bbox):
    aps, ars = [], []
    for i in range(len(gt_pres_mask)):
        ap, ar = bbox_precision_recall(gt_pres_mask[i], gt_bbox[i], pred_bbox[i])
        aps.append(ap)
        ars.append(ar)
    return float(np.mean(aps)), float(np.mean(ars))


# ---------------------------------------------------------------------------
# per-timestep aggregator
# ---------------------------------------------------------------------------

def _pixel_metrics_all_t(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """gt/pred [B, T, H, W, 3] in [-1, 1] -> [3, T]: per-step mse, psnr,
    ssim, every step in one batched pass."""
    B, T = gt.shape[:2]
    g = to_rgb_from_tensor(gt).flatten(0, 1)  # [B*T, H, W, 3]
    p = to_rgb_from_tensor(pred).flatten(0, 1)
    sq = (g - p) ** 2
    mse = sq.sum(dim=(1, 2)).reshape(B, T, -1).mean(dim=(0, 2))
    psnr = (-10.0 * torch.log10(torch.clamp(sq.mean(dim=(1, 2, 3)), min=1e-12))
            ).reshape(B, T).mean(0)
    # ssim_metric's mean over one step's maps, for every step
    S = _ssim_map(g.permute(0, 3, 1, 2) * 255.0, p.permute(0, 3, 1, 2) * 255.0,
                  255.0)
    ssim = S.reshape(B, T, -1).mean(dim=(0, 2))
    return torch.stack([mse, psnr, ssim])


def _traj_tables_all_t(gt_mask: torch.Tensor, pred_mask: torch.Tensor,
                       num_classes: int):
    """gt/pred [B, T, H, W] int ids -> per-step ARI [T], FG-ARI [T], the IoU
    tables [B, T, C-1, C] and each frame's largest gt id [B, T], every step
    in one batched pass."""
    B, T, H, W = gt_mask.shape
    g = gt_mask.reshape(B * T, 1, H, W)
    p = pred_mask.reshape(B * T, 1, H, W)
    ari = adjusted_rand_index(g, p, num_classes).reshape(B, T).mean(0)
    fari = adjusted_rand_index(
        g, p, num_classes, ignore_background=True).reshape(B, T).mean(0)
    gm = gt_mask.reshape(B * T, H * W)
    pm = pred_mask.reshape(B * T, H * W)
    tables = pairwise_iou_tables(gm, pm, num_classes, num_classes)
    return (ari, fari, tables.reshape(B, T, num_classes - 1, num_classes),
            gm.amax(1).reshape(B, T))


def pred_eval_step(gt, pred, lpips_fn=None, gt_mask=None, pred_mask=None,
                   gt_pres_mask=None, gt_bbox=None, pred_bbox=None,
                   eval_traj: bool = True, num_classes: Optional[int] = None,
                   device=None) -> Dict[str, List[float]]:
    """Per-timestep metric dict (reference vp_utils.py:258-344).

    gt/pred: [B, T, H, W, 3] in [-1, 1] (NHWC); gt may instead be uint8
    [0, 255] and is normalised on the device. masks: [B, T, H, W] of any int
    dtype; pres_mask [B, T, N]; bboxes [B, T, N/M, 4]. Tensors and numpy
    arrays are both accepted; the metrics are computed on ``device``
    (default: where ``pred`` lies, the CPU for a numpy ``pred``), in one
    batched pass over all T, and come to the host in one transfer.
    ``lpips_fn(x, y) -> [B]`` or None (``percept_dist`` is then 0).
    """
    if device is None:
        device = pred.device if isinstance(pred, torch.Tensor) else "cpu"
    gt, pred = _tensor(gt, device), _tensor(pred, device)
    if gt.dtype == torch.uint8:
        gt = gt.float() / 127.5 - 1.0
    assert gt.ndim == pred.ndim == 5 and gt.shape == pred.shape
    assert gt.shape[-1] == 3
    B, T = gt.shape[:2]

    on_device = {"pixel": _pixel_metrics_all_t(gt, pred)}
    if lpips_fn is not None:
        # one batched call over all timesteps
        on_device["percept"] = lpips_fn(
            gt.flatten(0, 1), pred.flatten(0, 1)).reshape(B, T).mean(0)
    if eval_traj:
        assert gt_mask is not None and pred_mask is not None
        gt_mask = _tensor(gt_mask, device).long()
        pred_mask = _tensor(pred_mask, device).long()
        nc = num_classes or int(max(gt_mask.max(), pred_mask.max())) + 1
        (on_device["ari"], on_device["fari"], on_device["tables"],
         on_device["n_eff"]) = _traj_tables_all_t(gt_mask, pred_mask, nc)
        if isinstance(pred_bbox, torch.Tensor):
            on_device["pred_bbox"] = pred_bbox
    # the one transfer: stack what fits into one float32 buffer
    keys = list(on_device)
    flat = torch.cat([on_device[k].reshape(-1).float() for k in keys]).cpu().numpy()
    host, pos = {}, 0
    for k in keys:
        n = on_device[k].numel()
        host[k] = flat[pos:pos + n].reshape(tuple(on_device[k].shape))
        pos += n

    mse, psnr, ssim = host["pixel"]
    all_percept = (host["percept"].astype(float).tolist()
                   if lpips_fn is not None else [0.0] * T)
    all_ari, all_fari, all_miou, all_ap, all_ar = [], [], [], [], []
    if eval_traj:
        all_ari = host["ari"].astype(float).tolist()
        all_fari = host["fari"].astype(float).tolist()
        tables, n_eff = host["tables"], host["n_eff"]
        pred_bbox = host.get("pred_bbox", pred_bbox)
        gt_pres_mask = _numpy(gt_pres_mask)
        gt_bbox, pred_bbox = _numpy(gt_bbox), _numpy(pred_bbox)
        for t in range(T):
            # small host Hungarians (at most C x C) over the device's tables
            all_miou.append(float(np.mean([
                hungarian_miou_from_table(tables[i, t], int(n_eff[i, t]))
                for i in range(B)])))
            ap, ar = batch_bbox_precision_recall(
                gt_pres_mask[:, t], gt_bbox[:, t], pred_bbox[:, t])
            all_ap.append(ap)
            all_ar.append(ar)
    else:
        all_ari = all_fari = all_miou = all_ap = all_ar = [0.0] * T

    return {
        "mse": mse.astype(float).tolist(),
        "ssim": ssim.astype(float).tolist(),
        "psnr": psnr.astype(float).tolist(),
        "percept_dist": all_percept,
        "ari": all_ari,
        "fari": all_fari,
        "miou": all_miou,
        "ap": all_ap,
        "ar": all_ar,
    }


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
