"""Port vs JAX: ``metrics/vp_metrics.py``, ``metrics/lpips.py`` and
``metrics/vis.py``.

Every function on the same random numpy inputs through the JAX package and
the port, and against the reference-executed goldens
(``metrics_golden.npz`` at tests/test_metrics_golden.py's tolerances,
``lpips_golden.npz`` at tests/test_lpips.py's).

Tolerances: integer outputs (mask ids, boxes, the greedy box matching) are
equal; the pixel metrics agree to rtol 1e-5 (float32 sums in different
orders), SSIM to 1e-4 (its variances are differences of large filtered
squares). ARI counts pixels in float32 on both sides (JAX runs with x64
off): over a 64x64 frame N*(N-1) reaches 1.7e7, past float32's exact
integers (2^24 = 1.68e7), so the sums may round differently and the scores
agree to 1e-5 absolute, not bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from slotformer_tpu.metrics import lpips as jl
from slotformer_tpu.metrics import vis as jvis
from slotformer_tpu.metrics import vp_metrics as jm
from slotformer_tpu_torch.metrics import lpips as pl
from slotformer_tpu_torch.metrics import vis as pvis
from slotformer_tpu_torch.metrics import vp_metrics as pm
from torch_port_helpers import GOLDEN, close, rng

ARI_ATOL = 1e-5


@pytest.fixture(scope="module")
def gold():
    return np.load(os.path.join(GOLDEN, "metrics_golden.npz"))


def _ids(r, shape, n):
    return r.integers(0, n, size=shape).astype(np.int32)


def _imgs(r, *shape):
    return r.uniform(0, 1, size=shape).astype(np.float32)


def _soft_masks(r, B=2, T=3, N=5, H=16, W=16):
    m = r.uniform(0, 1, size=(B, T, N, H, W, 1)).astype(np.float32)
    m[0, 0, :, :4] *= 0.3  # a block where no slot passes FG_THRE
    m[1, 1, 1] = m[1, 1, 3]  # two slots tied everywhere: the first index wins
    m[1, 2, :, 5, 5] = 0.7  # every slot tied at one pixel
    return m


def test_postproc_mask_and_boxes_match_jax():
    r = rng(0)
    soft = _soft_masks(r)
    want = np.asarray(jm.postproc_mask(soft))
    got = pm.postproc_mask(soft)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[1, 1] != 3).all()  # the tie went to the lower index
    for ids, n in ((want, 5), (_ids(r, (2, 3, 16, 16), 9), 7)):
        # ids >= num_boxes (the second case) fall in no box
        np.testing.assert_array_equal(
            pm.masks_to_boxes(ids, n).numpy(),
            np.asarray(jm.masks_to_boxes(ids, n)))
    empty = pm.masks_to_boxes(np.zeros((1, 1, 8, 8), np.int32), 3)
    np.testing.assert_array_equal(empty[0, 0, 1:].numpy(), -np.ones((2, 4)))


def test_pixel_metrics_match_jax():
    r = rng(1)
    x, y = _imgs(r, 3, 24, 20, 3), _imgs(r, 3, 24, 20, 3)
    close(pm.mse_metric(x, y), jm.mse_metric(x, y), rtol=1e-5, atol=0)
    close(pm.psnr_metric(x, y), jm.psnr_metric(x, y), rtol=1e-5, atol=0)
    close(pm.ssim_metric(x, y), jm.ssim_metric(x, y), rtol=1e-4, atol=0)
    # identical images: the MSE clamp at 1e-12 gives 120 dB, SSIM 1
    assert float(pm.psnr_metric(x, x)) == pytest.approx(120.0)
    assert float(jm.psnr_metric(x, x)) == pytest.approx(120.0)
    assert float(pm.ssim_metric(x, x)) == pytest.approx(1.0, abs=1e-6)
    close(pm.to_rgb_from_tensor(torch.from_numpy(x * 4 - 2)),
          jm.to_rgb_from_tensor(x * 4 - 2), rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(3, 2, 16, 16), (2, 64, 64)])
def test_ari_matches_jax(shape):
    r = rng(2)
    gt, pred = _ids(r, shape, 5), _ids(r, shape, 6)
    pred[0] = gt[0]  # a perfect sample
    gt[-1] = 2
    pred[-1] = 4  # one cluster each: the denominator is 0 -> 1.0
    for bg in (False, True):
        want = np.asarray(jm.adjusted_rand_index(gt, pred, 6, bg))
        got = pm.adjusted_rand_index(gt, pred, 6, bg)
        assert got.dtype == torch.float32 and got.shape == (shape[0],)
        close(got, want, rtol=0, atol=ARI_ATOL)
        assert float(got[-1]) == float(want[-1]) == 1.0
    assert pm.ARI_metric(gt, pred, 6) == pytest.approx(
        jm.ARI_metric(gt, pred, 6), abs=ARI_ATOL)
    assert pm.fARI_metric(gt, pred, 6) == pytest.approx(
        jm.fARI_metric(gt, pred, 6), abs=ARI_ATOL)
    with pytest.raises(AssertionError):
        pm.ARI_metric(gt.astype(np.float32), pred, 6)


def test_iou_tables_and_hungarian_match_jax():
    r = rng(3)
    gt, pred = _ids(r, (4, 16, 16), 5), _ids(r, (4, 16, 16), 8)
    gt[0][gt[0] == 3] = 0  # an id absent below the largest: an IoU-0 row
    gt[1] = 0  # all background: scores 1.0
    # pred ids up to 7 with 6 classes: the larger ids fall in no class, as
    # with jax.nn.one_hot, and index nothing out of range
    want = np.asarray(jm.pairwise_iou_tables(
        gt.reshape(4, -1), pred.reshape(4, -1), 5, 6))
    got = pm.pairwise_iou_tables(gt.reshape(4, -1), pred.reshape(4, -1), 5, 6)
    assert got.shape == (4, 4, 6)
    close(got, want, rtol=1e-6, atol=1e-7)
    for i in range(4):
        n_eff = int(gt[i].max())
        assert pm.hungarian_miou_from_table(want[i], n_eff) == pytest.approx(
            jm.hungarian_miou_from_table(want[i], n_eff), abs=1e-7)
    assert pm.hungarian_miou_from_table(want[1], 0) == 1.0
    assert pm.miou_metric(gt, pred, 5, 8) == pytest.approx(
        jm.miou_metric(gt, pred, 5, 8), abs=1e-6)


def test_bbox_matching_matches_jax():
    r = rng(4)
    lo = r.uniform(0, 10, size=(3, 6, 2))
    gt_box = np.concatenate([lo, lo + r.uniform(1, 6, size=(3, 6, 2))], -1).astype(np.float32)
    pred_box = gt_box + r.normal(0, 1.0, size=gt_box.shape).astype(np.float32)
    pred_box[:, 4:] = -1.0  # empty predictions
    pres = r.uniform(size=(3, 6)) > 0.3
    pres[2] = False  # nothing to detect
    np.testing.assert_allclose(pm.box_iou(gt_box[0], pred_box[0]),
                               jm.box_iou(gt_box[0], pred_box[0]))
    for i in range(3):
        assert (pm.bbox_precision_recall(pres[i], gt_box[i], pred_box[i])
                == jm.bbox_precision_recall(pres[i], gt_box[i], pred_box[i]))
    assert (pm.batch_bbox_precision_recall(pres, gt_box, pred_box)
            == jm.batch_bbox_precision_recall(pres, gt_box, pred_box))
    none = -np.ones((6, 4), np.float32)
    assert pm.bbox_precision_recall(pres[2], gt_box[2], none) == (1.0, 1.0)
    assert pm.bbox_precision_recall(pres[0], gt_box[0], none) == (0.0, 0.0)


def _eval_inputs(r, B=3, T=4, H=16, W=16, N=5):
    gt = r.uniform(-1, 1, size=(B, T, H, W, 3)).astype(np.float32)
    pred = np.clip(gt + r.normal(0, 0.2, size=gt.shape), -1.2, 1.2).astype(np.float32)
    gt_mask = _ids(r, (B, T, H, W), N)
    pred_mask = np.where(r.uniform(size=gt_mask.shape) < 0.8, gt_mask,
                         _ids(r, gt_mask.shape, N)).astype(np.int32)
    gt_bbox = np.asarray(jm.masks_to_boxes(gt_mask, N))[:, :, 1:]
    pres = gt_bbox[..., 0] >= 0
    pred_bbox = np.asarray(jm.masks_to_boxes(pred_mask, N))
    return dict(gt=gt, pred=pred, gt_mask=gt_mask, pred_mask=pred_mask,
                gt_pres_mask=pres, gt_bbox=gt_bbox, pred_bbox=pred_bbox)


@pytest.mark.parametrize("case", ["traj", "no_traj", "uint8_gt", "tensors_lpips"])
def test_pred_eval_step_matches_jax(case):
    kw = _eval_inputs(rng(5))
    jkw, pkw = dict(kw), dict(kw)
    if case == "no_traj":
        jkw = pkw = dict(gt=kw["gt"], pred=kw["pred"], eval_traj=False)
    elif case == "uint8_gt":
        q = ((kw["gt"] + 1.0) * 127.5).round().clip(0, 255).astype(np.uint8)
        jkw, pkw = dict(kw, gt=q, num_classes=6), dict(kw, gt=q, num_classes=6)
    elif case == "tensors_lpips":
        w = jl.untrained_lpips_weights(0)
        jkw["lpips_fn"] = jl._build_lpips_fn(w, "untrained")
        pkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        pkw["lpips_fn"] = pl._build_lpips_fn(w, "untrained")
    want = jm.pred_eval_step(**jkw)
    got = pm.pred_eval_step(**pkw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], list) and len(got[k]) == len(want[k]) == 4
        assert all(isinstance(v, float) for v in got[k])
        if k in ("mse", "psnr"):
            tol = dict(rtol=1e-5, atol=0)
        elif k in ("ssim", "percept_dist"):
            tol = dict(rtol=1e-4, atol=1e-7)
        elif k in ("ari", "fari", "miou"):
            tol = dict(rtol=0, atol=ARI_ATOL)
        else:
            tol = dict(rtol=0, atol=0)  # ap, ar: discrete
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    if case == "no_traj":
        assert got["ari"] == got["ar"] == got["percept_dist"] == [0.0] * 4


# ------------------------------------------------------- reference goldens

def _nhwc(x):  # [..., C, H, W] -> [..., H, W, C]
    return np.moveaxis(x, -3, -1)


def _img01(x):
    return np.clip(x * 0.5 + 0.5, 0.0, 1.0)


def test_golden_postproc_mask_and_boxes(gold):
    soft = np.moveaxis(gold["in/soft_masks"], 3, -1)  # [B, T, N, H, W, 1]
    np.testing.assert_array_equal(pm.postproc_mask(soft).numpy(),
                                  gold["out/pred_mask"])
    for key, masks in (("out/gt_bbox", gold["in/gt_mask"]),
                       ("out/pred_bbox", gold["out/pred_mask"])):
        got = pm.masks_to_boxes(masks.astype(np.int32), num_boxes=5)
        np.testing.assert_allclose(got.numpy(), gold[key], atol=1e-6)


def test_golden_pixel_metrics(gold):
    g = _img01(_nhwc(gold["in/gt_img"][:, 0]))
    p = _img01(_nhwc(gold["in/pred_img"][:, 0]))
    assert float(pm.mse_metric(g, p)) == pytest.approx(
        float(gold["out/mse_t0"]), rel=1e-5)
    assert float(pm.psnr_metric(g, p)) == pytest.approx(
        float(gold["out/psnr_t0"]), rel=1e-5)
    assert float(pm.ssim_metric(g, p)) == pytest.approx(
        float(gold["out/ssim_t0"]), rel=1e-4)


def test_golden_clustering_and_bbox_metrics(gold):
    gt = gold["in/gt_mask"][:, 0].astype(np.int32)
    pred = gold["out/pred_mask"][:, 0].astype(np.int32)
    nc = int(max(gt.max(), pred.max())) + 1
    assert pm.ARI_metric(gt, pred, nc) == pytest.approx(
        float(gold["out/ari"]), abs=1e-5)
    assert pm.fARI_metric(gt, pred, nc) == pytest.approx(
        float(gold["out/fari"]), abs=1e-5)
    # with the undetected-object penalty: sample 0 lacks gt id 3
    assert pm.miou_metric(gt, pred, nc, nc) == pytest.approx(
        float(gold["out/miou"]), abs=1e-5)
    ap, ar = pm.batch_bbox_precision_recall(
        gold["in/gt_pres"][:, 0], gold["out/gt_bbox"][:, 0],
        gold["out/pred_bbox"][:, 0])
    assert ap == pytest.approx(float(gold["out/ap"]), abs=1e-6)
    assert ar == pytest.approx(float(gold["out/ar"]), abs=1e-6)


def test_golden_pred_eval_step(gold):
    res = pm.pred_eval_step(
        gt=_nhwc(gold["in/gt_img"]), pred=_nhwc(gold["in/pred_img"]),
        lpips_fn=None, gt_mask=gold["in/gt_mask"].astype(np.int32),
        pred_mask=gold["out/pred_mask"].astype(np.int32),
        gt_pres_mask=gold["in/gt_pres"], gt_bbox=gold["out/gt_bbox"],
        pred_bbox=gold["out/pred_bbox"], eval_traj=True)
    for key in ("mse", "psnr", "ssim", "ari", "fari", "miou", "ap", "ar"):
        np.testing.assert_allclose(res[key], gold[f"out/step/{key}"],
                                   rtol=2e-4, atol=1e-5, err_msg=key)


# ------------------------------------------------------------------- LPIPS

def test_lpips_untrained_weights_are_the_jax_numbers():
    want, got = jl.untrained_lpips_weights(3), pl.untrained_lpips_weights(3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["conv1_1/kernel"].shape == (3, 3, 3, 64)  # HWIO on disk


def test_lpips_matches_jax_and_golden():
    g = np.load(os.path.join(GOLDEN, "lpips_golden.npz"))
    gfn = pl._build_lpips_fn(
        pl.untrained_lpips_weights(int(g["weight_seed"])), source="untrained")
    got = gfn(g["x"], g["y"])
    np.testing.assert_allclose(got.numpy(), g["expected"], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(gfn(g["x"], g["x"]).numpy(), 0.0, atol=1e-6)
    fn = pl.load_lpips("", fallback="untrained")
    assert fn.source == "untrained"
    r = rng(6)
    x = r.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    y = r.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    want = jl.load_lpips("", fallback="untrained")(x, y)
    close(fn(torch.from_numpy(x), torch.from_numpy(y)), want, rtol=2e-4, atol=1e-6)


def test_load_lpips_fallback_and_file_roundtrip(tmp_path, monkeypatch):
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    assert pl.load_lpips("") is None
    with pytest.raises(ValueError):
        pl.load_lpips("", fallback="zeros")
    # a file in the JAX package's format (HWIO) serves both
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **jl.untrained_lpips_weights(1))
    fn, jfn = pl.load_lpips(path), jl.load_lpips(path)
    assert fn.source == jfn.source == "file"
    r = rng(7)
    x = r.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    y = np.clip(x + 0.3, -1, 1)
    close(fn(x, y), jfn(x, y), rtol=2e-4, atol=1e-6)
    monkeypatch.setenv("LPIPS_WEIGHTS", path)
    assert pl.load_lpips(None).source == "file"
    d_small, d_big = fn(x, np.clip(x + 0.05, -1, 1)), fn(x, np.clip(x + 0.5, -1, 1))
    assert (d_big > d_small).all()


# --------------------------------------------------------------------- vis

def test_vis_helpers_match_jax():
    r = rng(8)
    gt = r.uniform(-1, 1, size=(5, 12, 12, 3)).astype(np.float32)
    pred = r.uniform(-1, 1, size=(5, 12, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(pvis.make_video(gt, pred, 2),
                                  jvis.make_video(gt, pred, 2))
    ids = _ids(r, (5, 12, 12), 20)
    np.testing.assert_array_equal(pvis.colorize_mask(ids), jvis.colorize_mask(ids))
    boxes = np.array([[[1, 2, 6, 8], [-1, -1, -1, -1]]] * 5, np.float32)
    pres = np.array([[True, False]] * 5)
    np.testing.assert_array_equal(pvis.batch_draw_bbox(gt, boxes, pres),
                                  jvis.batch_draw_bbox(gt, boxes, pres))
    np.testing.assert_array_equal(pm.PALETTE_np, jm.PALETTE_np)
