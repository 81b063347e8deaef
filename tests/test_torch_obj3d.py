"""Port vs JAX on OBJ3D: the datasets on a mini PNG tree the test writes,
the two shipped configs, one train step of a deterministic SAVi with the
OBJ3D config's structure (a transformer predictor wrapped in an LSTM,
``kld_method='none'``), and ``cli.extract_slots`` -> ``cli.test_vp`` on the
tree, each against the JAX package's CLI on the same weights.

The tree holds ``<split>/<video>/test_{1..51}.png`` (16x16; ``get_video``
reads ``video_len + 1`` = 51 frames). Tolerances: dataset items equal; the
train step's losses rtol 1e-6 and gradients 1e-5 of each gradient's largest
entry (float32 on both sides, dropout off, two frame steps); extracted
slots 1e-4 abs (51 recurrent frame steps); the ``test_vp`` metrics rtol and
atol 1e-4 (44 autoregressive rollout steps, float32 on both sides, the
ground truth read from the same PNGs).
"""

import os
import types

import jax
import numpy as np
import pytest

from slotformer_tpu.datasets.obj3d import Obj3DDataset as JaxObj3D
from slotformer_tpu.datasets.obj3d import Obj3DSlotsDataset as JaxObj3DSlots
from slotformer_tpu.datasets.utils import BaseTransforms as JaxTransforms
from slotformer_tpu.models.savi import StoSAVi as JaxStoSAVi
from slotformer_tpu.runtime import load_params as jax_load_params
from slotformer_tpu_torch.cli import extract_slots, test_vp
from slotformer_tpu_torch.datasets import build_dataset
from slotformer_tpu_torch.datasets.obj3d import Obj3DDataset, Obj3DSlotsDataset
from slotformer_tpu_torch.datasets.utils import BaseTransforms
from slotformer_tpu_torch.models.savi import StoSAVi
from slotformer_tpu_torch.runtime import load_obj, load_params
from test_torch_physion import _jax_and_port_ckpt
from test_torch_steve_training import _port_grads
from torch_port_helpers import close, randn, rng, t

RES, VIDEO_LEN, S, D = 16, 50, 3, 16
VIDEOS = {"train": ["vid_00", "vid_01"], "val": ["vid_02", "vid_03"],
          "test": ["vid_04"]}
LOSS_RTOL, GRAD_RTOL, SLOTS_ATOL, METRIC_TOL = 1e-6, 1e-5, 1e-4, 1e-4

# the OBJ3D SAVi at narrow widths: the shipped structure (transformer
# predictor in an LSTM, deterministic, 2 iterations, no norms)
SAVI = dict(
    resolution=(RES, RES), clip_len=2,
    slot_dict=dict(num_slots=S, slot_size=D, slot_mlp_size=32, num_iterations=2),
    enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=5, enc_out_channels=D,
                  enc_norm=""),
    dec_dict=dict(dec_channels=(D, 8, 8), dec_resolution=(4, 4), dec_ks=5,
                  dec_norm=""),
    pred_dict=dict(pred_type="transformer", pred_rnn=True, pred_norm_first=True,
                   pred_num_layers=2, pred_num_heads=2, pred_ffn_dim=32,
                   pred_sg_every=None),
    loss_dict=dict(use_post_recon_loss=True, kld_method="none"))

COMMON = f"""
    data_root = 'data/OBJ3D'
    resolution = ({RES}, {RES})
    frame_offset = 1
    video_len = {VIDEO_LEN}
    num_workers = 0
    slot_dict = dict(num_slots={S}, slot_size={D}, slot_mlp_size=32,
                     num_iterations=2)
    dec_dict = {SAVI['dec_dict']!r}
"""
SAVI_CFG = f"""
    model = 'StoSAVi'
    dataset = 'obj3d'
    n_sample_frames = 2
    input_frames = 2
    train_batch_size = 2
    val_batch_size = 2
    enc_dict = {SAVI['enc_dict']!r}
    pred_dict = {SAVI['pred_dict']!r}
    loss_dict = {SAVI['loss_dict']!r}
"""
SF_CFG = f"""
    model = 'SlotFormer'
    dataset = 'obj3d_slots'
    slots_root = 'data/OBJ3D/obj3d_slots.pkl'
    n_sample_frames = 8
    input_frames = 6
    train_batch_size = 2
    val_batch_size = 2
    rollout_dict = dict(num_slots={S}, slot_size={D}, history_len=6,
                        t_pe='sin', slots_pe='', d_model={D}, num_layers=1,
                        num_heads=2, ffn_dim=32, norm_first=True)
    loss_dict = dict(rollout_len=2, use_img_recon_loss=True)
"""


def _write_cfg(path, body, jax_side: bool) -> str:
    base = ("slotformer_tpu.runtime import BaseParams" if jax_side
            else "slotformer_tpu_torch.runtime.params import BaseParams")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"from {base}\n\n\nclass SlotFormerParams(BaseParams):"
                + COMMON + body)
    return str(path)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """The mini OBJ3D tree under ``data/OBJ3D`` of the working directory:
    smooth moving blobs, so that the pixel metrics see structure."""
    from PIL import Image

    r = np.random.default_rng(0)
    yy, xx = np.mgrid[:RES, :RES]
    for split, names in VIDEOS.items():
        for name in names:
            folder = tmp_path / "data" / "OBJ3D" / split / name
            folder.mkdir(parents=True)
            c, v, col = r.uniform(3, 13, 2), r.uniform(-0.2, 0.2, 2), r.uniform(0, 1, 3)
            for i in range(VIDEO_LEN + 1):
                cy, cx = c + i * v
                blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)[..., None]
                img = 0.2 + 0.8 * blob * col
                Image.fromarray((img * 255).round().astype(np.uint8)).save(
                    folder / f"test_{i + 1}.png")
    (tmp_path / "data" / "OBJ3D" / "train" / "notes.txt").write_text("not a video")
    monkeypatch.chdir(tmp_path)
    return tmp_path


# ------------------------------------------------------------ datasets

def test_obj3d_datasets_match_jax(tree):
    """Clip index, frames, box stubs and whole videos of every split."""
    for split, n_frames in (("train", 6), ("val", 16), ("test", 6)):
        kw = dict(data_root="data/OBJ3D", split=split, n_sample_frames=n_frames,
                  frame_offset=None, video_len=VIDEO_LEN)
        ours = Obj3DDataset(obj3d_transform=BaseTransforms((RES, RES)), **kw)
        theirs = JaxObj3D(obj3d_transform=JaxTransforms((RES, RES)), **kw)
        assert ours.files == theirs.files and ours.valid_idx == theirs.valid_idx
        assert len(ours) == len(theirs) == (
            2 * (VIDEO_LEN - n_frames + 1) if split == "train" else len(VIDEOS[split]))
        idxs = range(len(ours)) if split != "train" else [0, 7, 44, 45, len(ours) - 1]
        for i in idxs:
            a, b = ours[i], theirs[i]
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        ours.load_video = theirs.load_video = True
        assert len(ours) == len(theirs) == len(VIDEOS[split])
        a, b = ours[0], theirs[0]
        assert a["video"].shape == (VIDEO_LEN + 1, RES, RES, 3)
        np.testing.assert_array_equal(a["video"], b["video"])
    # frame offset 2: every other frame, 1-indexed names
    ours = Obj3DDataset("data/OBJ3D", "val", BaseTransforms((RES, RES)), 3, 2, VIDEO_LEN)
    theirs = JaxObj3D("data/OBJ3D", "val", JaxTransforms((RES, RES)), 3, 2, VIDEO_LEN)
    np.testing.assert_array_equal(ours[1]["img"], theirs[1]["img"])
    ours.load_video = theirs.load_video = True
    np.testing.assert_array_equal(ours[1]["video"], theirs[1]["video"])
    with pytest.raises(ValueError, match="splits"):
        Obj3DDataset("data/OBJ3D", "training", BaseTransforms((RES, RES)))

    slots = {n: randn(rng(1), VIDEO_LEN + 1, S, D) for n in VIDEOS["train"]}
    args = ("data/OBJ3D", slots, "train")
    ours = Obj3DSlotsDataset(*args, BaseTransforms((RES, RES)), 8, 1, VIDEO_LEN)
    theirs = JaxObj3DSlots(*args, JaxTransforms((RES, RES)), 8, 1, VIDEO_LEN)
    for i in (0, 5, len(ours) - 1):
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def test_build_dataset_dispatches_obj3d(tree):
    from slotformer_tpu_torch.runtime import dump_obj

    params = load_params(_write_cfg("port/savi_tiny_params.py", SAVI_CFG, False))
    train, val = build_dataset(params)
    assert isinstance(train, Obj3DDataset) and train.split == "train"
    assert len(val) == 2 and "bbox" in val[0] and "bbox" not in train[0]
    dump_obj({s: {n: randn(rng(2), VIDEO_LEN + 1, S, D) for n in VIDEOS[s]}
              for s in ("train", "val")}, "data/OBJ3D/obj3d_slots.pkl")
    params = load_params(_write_cfg("port/sf_tiny_params.py", SF_CFG, False))
    train, val = build_dataset(params)
    assert isinstance(val, Obj3DSlotsDataset) and val[0]["slots"].shape == (8, S, D)
    assert build_dataset(params, val_only=True).split == "val"


def test_configs_match_the_jax_package():
    """The two shipped configs, the decoder checkpoint's path apart (the
    port reads a ``.pth``)."""
    import slotformer_tpu
    import slotformer_tpu_torch

    jdir = os.path.join(os.path.dirname(slotformer_tpu.__file__), "configs")
    pdir = os.path.join(os.path.dirname(slotformer_tpu_torch.__file__), "configs")
    for name in ("savi_obj3d_params.py", "slotformer_obj3d_params.py"):
        ref = jax_load_params(os.path.join(jdir, name)).to_dict()
        got = load_params(os.path.join(pdir, name)).to_dict()
        if "dec_ckp_path" in ref["dec_dict"]:
            assert ref["dec_dict"].pop("dec_ckp_path").endswith(
                "savi_obj3d_params/model.ckpt.pkl")
            assert got["dec_dict"].pop("dec_ckp_path") == \
                "pretrained/savi_obj3d_params/model.pth"
        assert got == ref, name


# ---------------------------------------------------- one train step

def test_deterministic_savi_train_step_matches_jax():
    """The post-recon loss through two frame steps (K1's plain version),
    the LSTM-wrapped transformer predictor between them; no noise is asked
    for, and the KLD is 0."""
    img = np.tanh(randn(rng(30), 2, 2, RES, RES, 3))
    jmod = JaxStoSAVi(**SAVI)
    params = jax.tree.map(np.asarray, dict(jax.jit(jmod.init)(
        jax.random.PRNGKey(0), {"img": img})["params"]))
    port = StoSAVi(**SAVI).eval()  # dropout off, gradients on
    from slotformer_tpu_torch.runtime.weights import from_jax_params

    port.load_state_dict(from_jax_params(params, "StoSAVi",
                                         types.SimpleNamespace(**SAVI)))

    def loss_fn(p):
        out = jmod.apply({"params": p}, {"img": img}, deterministic=True)
        losses = jmod.apply({"params": p}, {"img": img}, out,
                            method="calc_train_loss")
        return losses["post_recon_loss"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    pl = port.train_loss({"img": t(img)})  # no generator: nothing is sampled
    pl["post_recon_loss"].backward()
    assert float(pl["kld_loss"]) == float(jl["kld_loss"]) == 0.0
    close(pl["post_recon_loss"], jl["post_recon_loss"], rtol=LOSS_RTOL, atol=0)
    want = _port_grads(jg, "StoSAVi", SAVI, port)
    n = 0
    for name, p in port.named_parameters():
        scale = float(np.abs(want[name].numpy()).max())
        close(p.grad, want[name], rtol=GRAD_RTOL, atol=GRAD_RTOL * scale + 1e-8)
        n += 1
    assert any("rnn" in name for name, _ in port.named_parameters()) and n > 40


# ------------------------------------------- extract_slots -> test_vp

def test_extract_and_test_vp_match_jax_clis(tree):
    """StoSAVi slots of the train and val videos through both CLIs, then a
    SlotFormer's ``test_vp`` on the val clips (6 + 44 frames, no masks):
    every metric array against JAX's."""
    from slotformer_tpu.cli.extract_slots import main as jax_extract
    from slotformer_tpu.cli.test_vp import main as jax_test_vp

    savi_port = _write_cfg("port/savi_tiny_params.py", SAVI_CFG, False)
    savi_jax = _write_cfg("jax/savi_tiny_params.py", SAVI_CFG, True)
    jax_ckp, port_ckp = _jax_and_port_ckpt(
        "savi_tiny_params", savi_jax, savi_port, "StoSAVi",
        {"img": np.zeros((1, 2, RES, RES, 3), np.float32)})
    args = ["--batch_size", "2", "--chunk_len", "20"]
    extract_slots.main(["--params", savi_port, "--weight", port_ckp,
                        "--save_path", "data/OBJ3D/obj3d_slots.pkl",
                        "--device", "cpu"] + args)
    jax_extract(["--params", savi_jax, "--weight", jax_ckp,
                 "--save_path", "jax/obj3d_slots.pkl"] + args)
    ours, theirs = load_obj("data/OBJ3D/obj3d_slots.pkl"), load_obj("jax/obj3d_slots.pkl")
    assert {k: sorted(v) for k, v in ours.items()} == {
        "train": VIDEOS["train"], "val": VIDEOS["val"]}
    for split in ours:
        for n, s in ours[split].items():
            assert s.shape == (VIDEO_LEN + 1, S, D) and s.dtype == np.float32
            np.testing.assert_allclose(s, theirs[split][n], rtol=0, atol=SLOTS_ATOL)

    sf_port = _write_cfg("port/sf_tiny_params.py", SF_CFG, False)
    sf_jax = _write_cfg("jax/sf_tiny_params.py", SF_CFG, True)
    jax_ckp, port_ckp = _jax_and_port_ckpt(
        "sf_tiny_params", sf_jax, sf_port, "SlotFormer",
        {"slots": np.zeros((1, 8, S, D), np.float32)})
    stats = test_vp.main(["--params", sf_port, "--weight", port_ckp,
                          "--vis_dir", "vis_port", "--device", "cpu"])
    jax_test_vp(["--params", sf_jax, "--weight", jax_ckp, "--vis_dir", "vis_jax",
                 "--wire", "f32"])
    assert stats["traj"]["batches"] == 0  # no masks on OBJ3D
    assert stats["save_dir"] == os.path.join("vis_port", "obj3d", "sf_tiny_params")
    for m in test_vp.METRICS:
        got = np.load(os.path.join(stats["save_dir"], f"{m}.npy"))
        want = np.load(os.path.join("vis_jax", "obj3d", "sf_tiny_params", f"{m}.npy"))
        assert got.shape == (VIDEO_LEN - 6,) and np.isfinite(got).all(), m
        np.testing.assert_allclose(got, want, rtol=METRIC_TOL, atol=METRIC_TOL,
                                   err_msg=m)
        if m in ("ari", "fari", "miou", "ar"):
            assert not got.any(), m  # not scored without masks
    assert (np.load(os.path.join(stats["save_dir"], "psnr.npy")) > 0).all()
    assert sorted(f for f in os.listdir(stats["save_dir"]) if f.endswith(".mp4")) == [
        "sf_tiny_params.mp4"]
