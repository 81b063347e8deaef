"""Port vs JAX: the slots datasets, the CLEVRER masks and ``filter_enter``,
``cli.test_vp`` against the reference's evaluation flow
(``testvp_golden.npz``), and the four-stage pipeline on the CPU.

The datasets are compared with the JAX package's on fixtures the tests write
(a miniature CLEVRER tree as tests/test_clevrer_fixture_e2e.py builds it):
index lists and every array equal. The ``testvp`` golden keeps
tests/test_testvp_e2e_parity.py's tolerances: rtol/atol 2e-3 on the pixel
metrics, which gather float32 differences through 6 autoregressive steps,
1e-4 on the mask and box metrics, which are discrete past the argmax.
"""

import json
import os

import numpy as np
import pytest
import torch

from slotformer_tpu.datasets.clevrer import CLEVRERDataset as JaxCLEVRER
from slotformer_tpu.datasets.clevrer import CLEVRERSlotsDataset as JaxCLEVRERSlots
from slotformer_tpu.datasets.utils import BaseTransforms as JaxTransforms
from slotformer_tpu.datasets import utils as jutils
from slotformer_tpu_torch import native
from slotformer_tpu_torch.cli import extract_slots, test_vp
from slotformer_tpu_torch.cli import train as train_cli
from slotformer_tpu_torch.datasets import (
    CLEVRERDataset,
    CLEVRERSlotsDataset,
    build_dataset,
)
from slotformer_tpu_torch.datasets import utils as putils
from slotformer_tpu_torch.runtime import (
    BaseDataModule,
    latest_checkpoint,
    load_checkpoint,
    load_obj,
    load_params,
    save_video,
)
from slotformer_tpu_torch.runtime import method as method_mod
from test_datasets import _rle_encode_compressed
from torch_port_helpers import GOLDEN, rng, write_params

VIDEO_LEN, H, W = 32, 24, 32
ENTER_VIDEO, ENTER_T = 10001, 17  # object 1 comes into view here


# ------------------------------------------------------------ mask utilities

def test_rle_decode_native_and_numpy_match_jax(monkeypatch):
    r = rng(0)
    masks = [(r.random((24, 32)) > 0.6).astype(np.uint8) for _ in range(3)]
    masks.append(np.zeros((5, 7), np.uint8))
    for m in masks:
        rle = _rle_encode_compressed(m)
        np.testing.assert_array_equal(putils.rle_decode(rle), m)
        np.testing.assert_array_equal(putils.rle_decode(rle),
                                      jutils.rle_decode(rle))
        flat = {"size": rle["size"], "counts": [int(m.size)]}  # all zeros
        np.testing.assert_array_equal(putils.rle_decode(flat),
                                      jutils.rle_decode(flat))
    # the numpy fallback, as without a C compiler
    monkeypatch.setattr(native, "rle_decode_native", lambda rle: None)
    for m in masks:
        np.testing.assert_array_equal(
            putils.rle_decode(_rle_encode_compressed(m)), m)


def test_native_library_builds_outside_native_dir():
    lib = native._build_and_load()
    if lib is None:
        pytest.skip("no C compiler: the numpy fallback is what runs")
    assert os.path.isfile(os.path.join(native._BUILD_DIR, "librle.so"))
    assert os.path.basename(os.path.dirname(native._BUILD_DIR)) == "build"


def test_mask_utils_match_jax():
    r = rng(1)
    masks = (r.random((5, 12, 10)) > 0.7).astype(np.uint8)
    masks[2] = 0  # an empty mask is dropped before the boxes are padded
    np.testing.assert_array_equal(putils.masks_to_boxes(masks),
                                  jutils.masks_to_boxes(masks))
    got, want = putils.masks_to_boxes_pad(masks, 7), jutils.masks_to_boxes_pad(masks, 7)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() == 4
    anno = {"objects": [{"mask": _rle_encode_compressed(m)} for m in masks[:2]]}
    np.testing.assert_array_equal(putils.anno2mask(anno), jutils.anno2mask(anno))
    ids = r.integers(0, 4, size=(3, 24, 32))
    for m in (ids, ids[0]):
        np.testing.assert_array_equal(
            putils.BaseTransforms((16, 16)).process_mask(m),
            JaxTransforms((16, 16)).process_mask(m))


# ------------------------------------------------------ the CLEVRER fixture

def _make_scene(video_id: int, split: str, root: str) -> None:
    """One video, its annotation and its proposals: two moving squares;
    object 1 of ENTER_VIDEO is out of view (empty mask) until ENTER_T."""
    r = np.random.default_rng(video_id)
    y0, y1 = int(r.integers(2, H - 8)), int(r.integers(2, H - 8))
    frames, proposals, trajectory = [], [], []
    for t in range(VIDEO_LEN):
        img = np.zeros((H, W, 3), np.float32)
        m0 = np.zeros((H, W), np.uint8)
        c0 = (2 + t // 2) % (W - 5)
        m0[y0:y0 + 5, c0:c0 + 5] = 1
        img[m0 > 0] = (1.0, 0.1, 0.1)
        obj1_in = not (video_id % 10000 == ENTER_VIDEO % 10000 and t < ENTER_T)
        m1 = np.zeros((H, W), np.uint8)
        if obj1_in:
            c1 = (6 + t // 3) % (W - 4)
            m1[y1:y1 + 4, c1:c1 + 4] = 1
            img[m1 > 0] = (0.1, 1.0, 0.1)
        frames.append(img)
        proposals.append({"frame_index": t, "objects": [
            {"mask": _rle_encode_compressed(m0)},
            {"mask": _rle_encode_compressed(m1)}]})
        trajectory.append({"frame_id": t, "objects": [
            {"inside_camera_view": True}, {"inside_camera_view": obj1_in}]})
    sub = f"video_{video_id // 1000 * 1000:05d}-{(video_id // 1000 + 1) * 1000:05d}"
    vdir = os.path.join(root, "videos", split, sub)
    save_video(np.stack(frames), os.path.join(vdir, f"video_{video_id:05d}.mp4"))
    adir = os.path.join(root, "annotations", split, sub.replace("video", "annotation"))
    os.makedirs(adir, exist_ok=True)
    with open(os.path.join(adir, f"annotation_{video_id:05d}.json"), "w") as f:
        json.dump({"motion_trajectory": trajectory}, f)
    pdir = os.path.join(root, "derender_proposals")
    os.makedirs(pdir, exist_ok=True)
    with open(os.path.join(pdir, f"proposal_{video_id:05d}.json"), "w") as f:
        json.dump({"frames": proposals}, f)


@pytest.fixture(scope="module")
def clevrer_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("clevrer_fixture"))
    for vid in (10000, 10001, 10002):
        _make_scene(vid, "val", root)
    for vid in (0, 1):
        _make_scene(vid, "train", root)
    return root


def _both(root, split, slots=None, **kw):
    common = dict(split=split, video_len=VIDEO_LEN, max_n_objects=2, **kw)
    if slots is None:
        return (CLEVRERDataset(root, (16, 16), **common),
                JaxCLEVRER(root, JaxTransforms((16, 16)), **common))
    return (CLEVRERSlotsDataset(root, slots, (16, 16), **common),
            JaxCLEVRERSlots(root, slots, JaxTransforms((16, 16)), **common))


@pytest.mark.parametrize("split,n_frames,offset,warmup", [
    ("train", 6, 2, 3), ("val", 6, 2, 3), ("val", 9, 1, 4), ("train", 10, 1, 2)])
def test_filter_enter_index_matches_jax(clevrer_tree, split, n_frames, offset,
                                        warmup):
    kw = dict(n_sample_frames=n_frames, frame_offset=offset, warmup_len=warmup)
    port, ref = _both(clevrer_tree, split, filter_enter=True, **kw)
    plain, _ = _both(clevrer_tree, split, filter_enter=False, **kw)
    assert port.valid_idx == ref.valid_idx and len(port) == len(ref) > 0
    if split == "train":
        assert len(port) < len(plain)  # the filter took something away
    else:  # one clean start for each half-clip interval, not each frame once
        assert port.valid_idx != plain.valid_idx
    enter = [i for i, f in enumerate(port.files) if f"{ENTER_VIDEO % 10000:04d}.mp4" in f]
    assert len(enter) == 1
    for v, s in port.valid_idx:
        if v == enter[0]:  # no kept clip has the entry after its burn-in
            t1 = s + (warmup - 3) * offset
            assert not (t1 < ENTER_T <= s + (n_frames - 1) * offset)


def test_clevrer_masks_and_boxes_match_jax(clevrer_tree):
    port, ref = _both(clevrer_tree, "val", n_sample_frames=6, frame_offset=2,
                      load_mask=True)
    assert port.valid_idx == ref.valid_idx
    for i in (0, len(port) // 2, len(port) - 1):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want)
        assert got["mask"].shape == (6, 16, 16) and got["mask"].dtype == np.int64
        assert got["bbox"].shape == (6, 3, 4) and got["pres_mask"].shape == (6, 3)
        assert got["mask"].max() >= 1 and not got["error_flag"]
        for k in ("img", "mask", "bbox", "pres_mask"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_clevrer_slots_dataset_matches_jax(clevrer_tree, monkeypatch):
    r = rng(2)
    names = [f"video_{v:05d}.mp4" for v in (10000, 10001, 10002)]
    slots = {n: r.standard_normal((VIDEO_LEN, 3, 8)).astype(np.float32)
             for n in names}
    kw = dict(n_sample_frames=6, frame_offset=2, warmup_len=3, load_img=True,
              load_mask=True, filter_enter=True)
    port, ref = _both(clevrer_tree, "val", slots=slots, **kw)
    assert port.valid_idx == ref.valid_idx and len(port) > 0
    for i in range(len(port)):
        got, want = port[i], ref[i]
        assert sorted(got) == sorted(want) and not got["error_flag"]
        assert got["slots"].shape == (6, 3, 8) and got["slots"].dtype == np.float32
        for k in ("slots", "img", "mask", "bbox", "pres_mask"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a video without slots is replaced by another clip and flagged
    lacking = {n: slots[n] for n in names[1:]}
    port, _ = _both(clevrer_tree, "val", slots=lacking, **kw)
    first_of_second = next(i for i, (v, _) in enumerate(port.valid_idx) if v == 1)
    monkeypatch.setattr(np.random, "choice", lambda n: first_of_second)
    with pytest.raises(ValueError, match="missing slots"):
        port._read_slots(0)
    out = port[0]
    assert out["error_flag"] and out["data_idx"] == first_of_second
    np.testing.assert_array_equal(out["slots"], port[first_of_second]["slots"])


def test_build_dataset_dispatches_the_slots_datasets(clevrer_tree, tmp_path):
    from slotformer_tpu_torch.runtime import BaseParams, dump_obj

    r = rng(3)
    slots = {"train": {f"video_{v:05d}.mp4": r.standard_normal((VIDEO_LEN, 3, 8))
                       for v in (0, 1)},
             "val": {f"video_{v:05d}.mp4": r.standard_normal((VIDEO_LEN, 3, 8))
                     for v in (10000, 10001, 10002)}}
    path = str(tmp_path / "slots.pkl")
    dump_obj(slots, path)
    params = BaseParams(dataset="clevrer_slots", data_root=clevrer_tree,
                        slots_root=path, resolution=(16, 16), n_sample_frames=6,
                        input_frames=3, frame_offset=2, load_img=False,
                        filter_enter=False)
    train, val = build_dataset(params)
    assert isinstance(train, CLEVRERSlotsDataset) and train.split == "train"
    assert val.video_slots is not train.video_slots and len(val.files) == 3
    params.dataset = "nope"
    with pytest.raises(NotImplementedError, match="clevrer_slots"):
        build_dataset(params)


def test_shipped_config_fails_at_the_missing_slots_file(tmp_path, monkeypatch):
    """``cli.train`` on the shipped ``slotformer_clevrer`` config gets as far
    as the data, which is not in the repository."""
    import slotformer_tpu_torch

    cfg = os.path.join(os.path.dirname(slotformer_tpu_torch.__file__), "configs",
                       "slotformer_clevrer_params.py")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="clevrer_slots.pkl"):
        train_cli.main(["--params", cfg, "--device", "cpu"])


# -------------------------------------------------- the testvp golden gate

# the values of tests/golden/testvp_cfg.py, which imports the JAX package
TESTVP_CFG = dict(
    project="golden", model="SlotFormer", dataset="synthetic_slots",
    slots_root=os.path.join(GOLDEN, "testvp_slots.pkl"), num_videos_val=10,
    num_videos_train=2, video_len=10, resolution=(16, 16), num_objects=3,
    n_sample_frames=10, input_frames=4, frame_offset=1, load_img=True,
    load_mask=True, num_workers=0, train_batch_size=8, val_batch_size=8,
    slot_dict=dict(num_slots=5, slot_size=16),
    rollout_dict=dict(num_slots=5, slot_size=16, history_len=4, t_pe="sin",
                      slots_pe="", d_model=16, num_layers=2, num_heads=2,
                      ffn_dim=32, norm_first=True),
    dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4), dec_ks=3,
                  dec_norm="", dec_ckp_path=""),
    loss_dict=dict(rollout_len=6, use_img_recon_loss=True),
    slot_recon_loss_w=1., img_recon_loss_w=1., optimizer="Adam", lr=1e-3,
    warmup_steps_pct=0.1, max_epochs=1)


@pytest.fixture(scope="module")
def testvp_gold():
    return np.load(os.path.join(GOLDEN, "testvp_golden.npz"))


def test_testvp_cfg_copy_matches_the_jax_config():
    from slotformer_tpu.runtime import load_params as jax_load_params

    ref = jax_load_params(os.path.join(GOLDEN, "testvp_cfg.py")).to_dict()
    assert {k: ref[k] for k in TESTVP_CFG} == TESTVP_CFG


def test_synthetic_slots_batches_match_golden(testvp_gold, tmp_path):
    """The loader gives exactly the batches the reference flow consumed."""
    cfg = write_params(tmp_path / "testvp_cfg.py", TESTVP_CFG)
    params = test_vp.adjust_params(load_params(cfg), batch_size=-1)
    assert params.val_batch_size == 8 and params.loss_dict["rollout_len"] == 6
    val_set = build_dataset(params, val_only=True)
    batches = list(BaseDataModule(params, None, val_set).val_loader)
    assert len(batches) == 2
    for bi, b in enumerate(batches):
        for k in ("img", "slots", "mask", "bbox", "pres_mask", "data_idx",
                  "error_flag"):
            np.testing.assert_array_equal(
                np.asarray(b[k]), testvp_gold[f"batch{bi}/{k}"], err_msg=f"b{bi}/{k}")


def test_testvp_golden_gate(testvp_gold, tmp_path, capsys):
    """``cli.test_vp`` on the golden ``sd/`` saved as a reference ``.pth``:
    the per-step metrics of the reference's evaluation flow."""
    sd = {k[3:]: torch.from_numpy(testvp_gold[k])
          for k in testvp_gold.files if k.startswith("sd/")}
    weight = str(tmp_path / "ref_sf.pth")
    torch.save({"state_dict": sd}, weight)
    cfg = write_params(tmp_path / "testvp_cfg.py", TESTVP_CFG)
    vis = str(tmp_path / "vis")
    stats = test_vp.main(["--params", cfg, "--weight", weight, "--vis_dir", vis,
                          "--device", "cpu"])
    save_dir = os.path.join(vis, "synthetic", "testvp_cfg")
    assert stats["save_dir"] == save_dir and stats["traj"]["batches"] == 2
    for m in ("mse", "psnr", "ssim", "ari", "fari", "miou", "ar"):
        ours = np.load(os.path.join(save_dir, f"{m}.npy"))
        tol = (dict(rtol=2e-3, atol=2e-3) if m in ("mse", "psnr", "ssim")
               else dict(rtol=1e-4, atol=1e-4))
        np.testing.assert_allclose(ours, testvp_gold[f"metric/{m}"], err_msg=m, **tol)
    percept = np.load(os.path.join(save_dir, "percept_dist.npy"))
    assert percept.shape == (6,) and (percept > 0).all()
    for name in ("testvp_cfg.mp4", "testvp_cfg_mask.mp4", "testvp_cfg_bbox.mp4"):
        assert os.path.getsize(os.path.join(save_dir, name)) > 0
    out = capsys.readouterr().out
    assert "eval_traj=True traj_batches=2" in out
    assert "percept_dist_source=untrained" in out and "UNTRAINED VGG" in out
    assert "(warm-up)" in out and "gt quantized" not in out


def test_adjust_params_per_dataset():
    from slotformer_tpu.cli.test_vp import adjust_params as jax_adjust
    from slotformer_tpu.runtime import BaseParams as JaxParams
    from slotformer_tpu_torch.runtime import BaseParams

    for ds, bs in (("clevrer_slots", -1), ("synthetic_slots", 5), ("obj3d_slots", -1)):
        kw = dict(dataset=ds, model="SlotFormer", input_frames=6, video_len=14,
                  loss_dict=dict(rollout_len=10))
        got = test_vp.adjust_params(BaseParams(**kw), bs).to_dict()
        assert got == jax_adjust(JaxParams(**kw), bs).to_dict()
    with pytest.raises(NotImplementedError):
        test_vp.adjust_params(BaseParams(dataset="synthetic_slots", model="StoSAVi",
                                         input_frames=2, loss_dict={}), -1)
    with pytest.raises(NotImplementedError):
        test_vp.adjust_params(BaseParams(dataset="phyre", model="SlotFormer",
                                         input_frames=2, loss_dict={}), -1)


# ------------------------------------------------- the four stages, on the CPU

SAVI_CFG = dict(
    model="StoSAVi", max_epochs=1, save_interval=1.0, eval_interval=1,
    print_iter=1, optimizer="Adam", lr=1e-3, clip_grad=0.05,
    warmup_steps_pct=0.1, dataset="synthetic", num_videos_train=4,
    num_videos_val=4, video_len=10, n_sample_frames=3, frame_offset=1,
    train_batch_size=8, val_batch_size=4, num_workers=0, resolution=(32, 32),
    input_frames=3, n_samples=2,
    slot_dict=dict(num_slots=4, slot_size=16, slot_mlp_size=32,
                   num_iterations=2, kernel_mlp=False),
    enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=3, enc_out_channels=16),
    dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(8, 8), dec_ks=3),
    pred_dict=dict(pred_type="mlp", pred_rnn=False, pred_norm_first=True),
    loss_dict=dict(use_post_recon_loss=True, kld_method="var-0.01"),
    post_recon_loss_w=1.0, kld_loss_w=1e-4)

SF_CFG = dict(
    model="SlotFormer", max_epochs=2, save_interval=1.0, eval_interval=1,
    print_iter=1, optimizer="Adam", lr=1e-3, warmup_steps_pct=0.1,
    dataset="synthetic_slots", num_videos_train=4, num_videos_val=4,
    video_len=10, n_sample_frames=6, frame_offset=1, load_img=True,
    train_batch_size=8, val_batch_size=4, num_workers=0, resolution=(32, 32),
    input_frames=3, n_samples=2, use_loss_decay=True, loss_decay_pct=0.5,
    slot_dict=dict(num_slots=4, slot_size=16),
    rollout_dict=dict(num_slots=4, slot_size=16, history_len=3, t_pe="sin",
                      d_model=16, num_layers=1, num_heads=2, ffn_dim=32),
    # 8 clips x 3 rollout frames = 24 frames in chunks of 8
    loss_dict=dict(rollout_len=3, use_img_recon_loss=True, dec_chunk_frames=8),
    slot_recon_loss_w=1.0, img_recon_loss_w=1.0)


def test_four_stage_pipeline_on_cpu(tmp_path, monkeypatch):
    """StoSAVi training -> slot extraction -> SlotFormer training on the
    extracted slots (grafted frozen decoder, ramp, resume without grafting
    again) -> ``test_vp``: every CLI of the flagship pipeline with
    ``--device cpu``, after tests/test_pipeline_e2e.py."""
    monkeypatch.chdir(tmp_path)
    log = []
    orig = method_mod.BaseMethod._log
    monkeypatch.setattr(method_mod.BaseMethod, "_log",
                        lambda self, rec: (log.append(rec), orig(self, rec)))
    # stage 1
    savi_cfg = write_params(tmp_path / "savi_synth_params.py", SAVI_CFG)
    savi_ckp = str(tmp_path / "savi_ckp")
    train_cli.main(["--params", savi_cfg, "--ckp_path", savi_ckp,
                    "--san_check_val_step", "0", "--device", "cpu"])
    savi_weight = latest_checkpoint(savi_ckp)
    assert savi_weight.endswith("model_4.pth")  # 32 clips // 8
    # the per-slot grids of SAViMethod._sample_video
    assert os.path.getsize(os.path.join(savi_ckp, "vis", "decomp_4.mp4")) > 0
    # stage 2
    slots_path = str(tmp_path / "synth_slots.pkl")
    extract_slots.main(["--params", savi_cfg, "--weight", savi_weight,
                        "--save_path", slots_path, "--batch_size", "4",
                        "--chunk_len", "6", "--device", "cpu"])
    slots = load_obj(slots_path)
    assert {k: len(v) for k, v in slots.items()} == {"train": 4, "val": 4}
    some = next(iter(slots["train"].values()))
    assert some.shape == (10, 4, 16) and np.isfinite(some).all()
    # stage 3
    sf_attrs = dict(SF_CFG, slots_root=slots_path)
    sf_attrs["dec_dict"] = dict(dec_channels=(16, 8, 8), dec_resolution=(8, 8),
                                dec_ks=3, dec_ckp_path=savi_weight)
    sf_cfg = write_params(tmp_path / "slotformer_synth_params.py", sf_attrs)
    sf_ckp = str(tmp_path / "sf_ckp")
    args = ["--params", sf_cfg, "--ckp_path", sf_ckp, "--device", "cpu"]
    del log[:]
    train_cli.main(args + ["--san_check_val_step", "1"])
    train = [r for r in log if r["phase"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4]  # 20 clips // 8, 2 epochs
    assert all(np.isfinite(r["img_recon_loss"]) and np.isfinite(r["slot_recon_loss"])
               for r in train)
    np.testing.assert_allclose([r["loss_decay_factor"] for r in train],
                               [min(0.01 + i / 2 * 0.99, 1.0) for i in range(4)])
    val = [r for r in log if r["phase"] == "val"]
    assert len(val) == 3 and "slot_recon_loss_3" in val[-1]
    assert os.path.getsize(os.path.join(sf_ckp, "vis", "rollout_4.mp4")) > 0
    sf_weight = latest_checkpoint(sf_ckp)
    trained = load_checkpoint(sf_weight)["state_dict"]
    savi_sd = load_checkpoint(savi_weight)["state_dict"]
    dec_keys = [k for k in trained if k.startswith("decoder")]
    assert len(dec_keys) == 9
    for k in dec_keys:  # grafted, then bit-frozen through training
        assert torch.equal(trained[k], savi_sd[k]), k
    # a resume must not graft again: move the SAVi checkpoint away
    os.rename(savi_weight, savi_weight + ".moved")
    os.remove(sf_weight)
    del log[:]
    train_cli.main(args + ["--auto_resume", "--san_check_val_step", "0"])
    assert [r["step"] for r in log if r["phase"] == "train"] == [3, 4]
    resumed = load_checkpoint(sf_weight)["state_dict"]
    for k in dec_keys:
        assert torch.equal(resumed[k], savi_sd[k]), k
    # stage 4
    vis = tmp_path / "vis"
    stats = test_vp.main(["--params", sf_cfg, "--weight", sf_weight,
                          "--batch_size", "2", "--vis_dir", str(vis),
                          "--device", "cpu"])
    out_dir = vis / "synthetic" / "slotformer_synth_params"
    for m in test_vp.METRICS:
        arr = np.load(out_dir / f"{m}.npy")
        assert arr.shape == (7,) and np.isfinite(arr).all(), m
    assert len(list(out_dir.glob("*.npy"))) == 8
    assert sorted(p.name for p in out_dir.glob("*.mp4")) == [
        "slotformer_synth_params.mp4", "slotformer_synth_params_bbox.mp4",
        "slotformer_synth_params_mask.mp4"]
    assert stats["traj"]["batches"] == 2 and stats["steady_frames"] == 2 * 7
    assert np.load(out_dir / "psnr.npy").mean() > 5.0  # a sane pixel range
    # --save_num writes the videos only
    assert test_vp.main(["--params", sf_cfg, "--weight", sf_weight,
                         "--save_num", "1", "--vis_dir", str(tmp_path / "vis2"),
                         "--device", "cpu"]) is None
    assert not list((tmp_path / "vis2").rglob("*.npy"))
