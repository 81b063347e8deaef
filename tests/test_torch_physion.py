"""Port vs JAX on a mini on-disk Physion tree: the datasets (clip index,
frames, the ``TrainMP4s`` -> ``TrainNpys-$dvae`` token path), then the
inference pipeline ``tokenize_images`` -> ``extract_slots`` (STEVE, the
training and readout subsets) -> ``rollout_slots --task physion`` through
the CLIs on the CPU, each against the JAX package's CLI on the same weights.

The tree holds frame folders ``PhysionTrainMP4s/<task>/<video>/%06d.jpg``
(16x16, 8 frames) and mini split files; both packages' ``_SPLIT_DIR`` point
at them. Tolerances: token ids equal; slots 1e-4 abs (8 recurrent frame
steps of slot attention); rolled-out slots 1e-4 abs.
"""

import json
import os
import types

import jax
import numpy as np
import pytest

import slotformer_tpu.datasets.physion as jax_physion
import slotformer_tpu_torch.datasets.physion as physion
from slotformer_tpu.datasets.utils import BaseTransforms as JaxTransforms
from slotformer_tpu.models import build_model as jax_build_model
from slotformer_tpu.runtime import load_params as jax_load_params
from slotformer_tpu.runtime import save_checkpoint as jax_save_checkpoint
from slotformer_tpu_torch.datasets import build_dataset
from slotformer_tpu_torch.datasets.utils import BaseTransforms
from slotformer_tpu_torch.runtime import load_obj, load_params, save_checkpoint
from slotformer_tpu_torch.runtime.weights import from_jax_params

RES, VIDEO_LEN, S, D, OBS = 16, 8, 3, 16, 4
VIDEOS = {  # (subset, split): {task: [video, ...]}
    ("training", "train"): {"Collide": ["vid_a"], "Roll": ["vid_b"]},
    ("training", "val"): {"Collide": ["vid_c"]},
    ("readout", "train"): {"Collide": ["ro_a"], "Roll": ["ro_b"]},
    ("readout", "val"): {"Roll": ["ro_c_img"]},
}

COMMON = f"""
    tasks = ['all']
    data_root = 'data/Physion'
    resolution = ({RES}, {RES})
    video_len = {VIDEO_LEN}
    frame_offset = 1
    num_workers = 0
    train_batch_size = 2
    val_batch_size = 2
"""
DVAE_CFG = """
    model = 'dVAE'
    dataset = 'physion_training'
    n_sample_frames = 1
    vocab_size = 16
"""
STEVE_CFG = f"""
    model = 'STEVE'
    dataset = 'physion_training'
    n_sample_frames = 2
    input_frames = 2
    slot_dict = dict(num_slots={S}, slot_size={D}, slot_mlp_size=32,
                     num_iterations=2)
    dvae_dict = dict(down_factor=4, vocab_size=16,
                     dvae_ckp_path='ckpts/dvae_tiny_params/model.pth')
    enc_dict = dict(enc_channels=(3, 8, 8), enc_ks=3, enc_out_channels={D},
                    enc_norm='')
    dec_dict = dict(dec_num_layers=1, dec_num_heads=2, dec_d_model={D})
    pred_dict = dict(pred_type='transformer', pred_rnn=True,
                     pred_norm_first=True, pred_num_layers=1,
                     pred_num_heads=2, pred_ffn_dim=32, pred_sg_every=None)
    loss_dict = dict(use_img_recon_loss=False)
"""
SF_CFG = f"""
    model = 'STEVESlotFormer'
    dataset = 'physion_slots_training'
    slots_root = '{{slots_root}}'
    n_sample_frames = 6
    input_frames = {OBS}
    slot_dict = dict(num_slots={S}, slot_size={D})
    dvae_dict = dict(down_factor=4, vocab_size=16,
                     dvae_ckp_path='ckpts/dvae_tiny_params/model.pth')
    dec_dict = dict(dec_num_layers=1, dec_num_heads=2, dec_d_model={D})
    rollout_dict = dict(num_slots={S}, slot_size={D}, history_len={OBS},
                        t_pe='sin', slots_pe='', d_model=16, num_layers=1,
                        num_heads=2, ffn_dim=32, norm_first=True)
    loss_dict = dict(rollout_len=2, use_img_recon_loss=False)
"""


def _write_cfg(path, body, jax_side: bool) -> str:
    base = ("slotformer_tpu.runtime import BaseParams" if jax_side
            else "slotformer_tpu_torch.runtime.params import BaseParams")
    with open(path, "w") as f:
        f.write(f"from {base}\n\n\nclass SlotFormerParams(BaseParams):"
                + COMMON + body)
    return str(path)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """The mini Physion tree as the working directory, both packages' split
    directories pointed at its split files."""
    from PIL import Image

    r = np.random.default_rng(0)
    splits = tmp_path / "splits"
    splits.mkdir()
    for (subset, split), tasks in VIDEOS.items():
        listing = {}
        for task, names in tasks.items():
            listing[task] = []
            for name in names:
                rel = f"PhysionTrainMP4s/{task}/{name}"
                folder = tmp_path / "data" / "Physion" / rel
                folder.mkdir(parents=True)
                for i in range(VIDEO_LEN):
                    Image.fromarray(r.integers(0, 256, (RES, RES, 3), np.uint8)).save(
                        folder / f"{i:06d}.jpg")
                listing[task].append(rel + ".mp4")
        with open(splits / f"{subset}_{split}.json", "w") as f:
            json.dump(listing, f)
    monkeypatch.setattr(physion, "_SPLIT_DIR", str(splits))
    monkeypatch.setattr(jax_physion, "_SPLIT_DIR", str(splits))
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_physion_datasets_match_jax(tree):
    """Clip index, frames and tokens of both splits of the training
    subset (clips of 3 frames at offset 2), and the slots dataset."""
    tokens = np.arange(VIDEO_LEN * 16, dtype=np.int32).reshape(VIDEO_LEN, 16)
    npy = physion.token_path("data/Physion/PhysionTrainMP4s/Collide/vid_a",
                             "dvae_tiny_params")
    assert npy == "data/Physion/PhysionTrainNpys-dvae_tiny_params/Collide/vid_a.npy"
    os.makedirs(os.path.dirname(npy))
    np.save(npy, tokens)
    kw = dict(data_root="data/Physion", tasks=["all"], n_sample_frames=3,
              frame_offset=2, video_len=VIDEO_LEN, subset="training")
    for split in ("train", "val"):
        ours = physion.PhysionDataset(split=split, physion_transform=BaseTransforms((RES, RES)), **kw)
        theirs = jax_physion.PhysionDataset(split=split, physion_transform=JaxTransforms((RES, RES)), **kw)
        ours.dvae_path = theirs.dvae_path = "dvae_tiny_params"
        assert ours.files == theirs.files and ours.valid_idx == theirs.valid_idx
        assert ours.video_idx2task_idx == theirs.video_idx2task_idx
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert sorted(a) == sorted(b)
            np.testing.assert_array_equal(a["img"], b["img"])
            if "token_id" in b:
                np.testing.assert_array_equal(a["token_id"], b["token_id"])
        ours.load_video = theirs.load_video = True
        np.testing.assert_array_equal(ours[0]["video"], theirs[0]["video"])
    a = physion.PhysionDataset(split="train", physion_transform=BaseTransforms((RES, RES)), **kw)
    a.dvae_path = "dvae_tiny_params"
    np.testing.assert_array_equal(a[1]["token_id"], tokens[[1, 3, 5]])

    slots = {n: np.random.default_rng(1).standard_normal((VIDEO_LEN, S, D)).astype(np.float32)
             for n in ("vid_a", "vid_b")}
    ours = physion.PhysionSlotsDataset("data/Physion", slots, "train", ["all"],
                                       BaseTransforms((RES, RES)), 3, 2, VIDEO_LEN)
    theirs = jax_physion.PhysionSlotsDataset("data/Physion", slots, "train", ["all"],
                                             JaxTransforms((RES, RES)), 3, 2, VIDEO_LEN)
    for i in range(len(ours)):
        np.testing.assert_array_equal(ours[i]["slots"], theirs[i]["slots"])

    # the dispatcher strips the subset suffix
    params = types.SimpleNamespace(
        dataset="physion_readout", data_root="data/Physion", tasks=["all"],
        resolution=(RES, RES), n_sample_frames=2, frame_offset=1,
        video_len=VIDEO_LEN, has=lambda k: False)
    train, val = build_dataset(params)
    assert len(train.files) == 2 and len(val.files) == 1


def _jax_and_port_ckpt(name, jax_cfg, port_cfg, kind, init_batch):
    """A random JAX checkpoint and the same weights as a port checkpoint."""
    params = jax_load_params(jax_cfg)
    model = jax_build_model(params)
    key = jax.random.PRNGKey(0)
    tree = jax.jit(model.init)({"params": key, "sample": key}, init_batch)["params"]
    tree = jax.tree.map(np.asarray, dict(tree))
    jax_ckp = f"ckpts/jax_{name}/model.ckpt.pkl"
    jax_save_checkpoint(jax_ckp, tree, step=0)
    port_ckp = f"ckpts/{name}/model.pth"
    save_checkpoint(port_ckp, from_jax_params(tree, kind, load_params(port_cfg)))
    return jax_ckp, port_ckp


def test_physion_pipeline_matches_jax_clis(tree):
    from slotformer_tpu.cli.extract_slots import main as jax_extract
    from slotformer_tpu.cli.rollout_slots import main as jax_rollout
    from slotformer_tpu.cli.tokenize_images import main as jax_tokenize
    from slotformer_tpu_torch.cli import extract_slots, rollout_slots, tokenize_images

    data = "data/Physion"
    # ---- dVAE tokens; the two sides' config names give two token trees
    port_cfg = _write_cfg("dvae_tiny_params.py", DVAE_CFG, False)
    jax_cfg = _write_cfg("dvae_jax_params.py", DVAE_CFG, True)
    jax_ckp, port_ckp = _jax_and_port_ckpt(
        "dvae_tiny_params", jax_cfg, port_cfg, "dVAE",
        {"img": np.zeros((1, RES, RES, 3), np.float32)})
    stats = tokenize_images.main(["--params", port_cfg, "--weight", port_ckp,
                                  "--batch_size", "3", "--device", "cpu"])
    jax_tokenize(["--params", jax_cfg, "--weight", jax_ckp, "--batch_size", "3"])
    assert stats["train"]["written"] == 2 and stats["val"]["frames"] == VIDEO_LEN
    for task, name in (("Collide", "vid_a"), ("Roll", "vid_b"), ("Collide", "vid_c")):
        ours = np.load(f"{data}/PhysionTrainNpys-dvae_tiny_params/{task}/{name}.npy")
        theirs = np.load(f"{data}/PhysionTrainNpys-dvae_jax_params/{task}/{name}.npy")
        assert ours.shape == (VIDEO_LEN, 16) and ours.dtype == np.int32
        np.testing.assert_array_equal(ours, theirs)
    again = tokenize_images.main(["--params", port_cfg, "--weight", port_ckp,
                                  "--device", "cpu"])
    assert again["train"] == dict(written=0, skipped=2, frames=0)
    # the STEVE dataset reads them back through the path rewrite
    steve_port_cfg = _write_cfg("steve_tiny_params.py", STEVE_CFG, False)
    item = build_dataset(load_params(steve_port_cfg))[0][0]
    assert item["token_id"].shape == (2, 16)

    # ---- STEVE slots of the training and readout subsets
    steve_jax_cfg = _write_cfg("steve_jax_params.py", STEVE_CFG, True)
    jax_ckp, port_ckp = _jax_and_port_ckpt(
        "steve_tiny_params", steve_jax_cfg, steve_port_cfg, "STEVE",
        {"img": np.zeros((1, 2, RES, RES, 3), np.float32)})
    for subset in ("training", "readout"):
        args = ["--batch_size", "2", "--chunk_len", "5", "--subset", subset]
        extract_slots.main(["--params", steve_port_cfg, "--weight", port_ckp,
                            "--save_path", f"{data}/{subset}_slots.pkl",
                            "--device", "cpu"] + args)
        jax_extract(["--params", steve_jax_cfg, "--weight", jax_ckp,
                     "--save_path", f"jax/{subset}_slots.pkl"] + args)
        assert os.path.islink(f"ckpts/steve_tiny_params/{subset}_slots.pkl")
        ours, theirs = load_obj(f"{data}/{subset}_slots.pkl"), load_obj(f"jax/{subset}_slots.pkl")
        assert set(ours) == {"train", "val"}
        for split in ours:
            assert set(ours[split]) == set(theirs[split])
            for n, s in ours[split].items():
                assert s.shape == (VIDEO_LEN, S, D)
                np.testing.assert_allclose(s, theirs[split][n], rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="subset"):
        extract_slots.main(["--params", steve_port_cfg, "--weight", port_ckp,
                            "--save_path", "slots.pkl", "--subset", "readout",
                            "--device", "cpu"])

    # ---- STEVESlotFormer rollout of the readout slots, OBS -> VIDEO_LEN
    body = SF_CFG.format(slots_root=f"{data}/training_slots.pkl")
    sf_port_cfg = _write_cfg("sf_tiny_params.py", body, False)
    sf_jax_cfg = _write_cfg("sf_jax_params.py", body, True)
    jax_ckp, port_ckp = _jax_and_port_ckpt(
        "sf_tiny_params", sf_jax_cfg, sf_port_cfg, "STEVESlotFormer",
        {"slots": np.zeros((1, 6, S, D), np.float32)})
    args = ["--task", "physion", "--subset", "readout", "--batch_size", "2",
            "--obs_frames", str(OBS)]
    rollout_slots.main(args + ["--params", sf_port_cfg, "--weight", port_ckp,
                               "--save_path", "out/rollout_readout_slots.pkl",
                               "--device", "cpu"])
    jax_rollout(args + ["--params", sf_jax_cfg, "--weight", jax_ckp,
                        "--save_path", "jax/rollout_readout_slots.pkl"])
    assert os.path.islink("ckpts/sf_tiny_params/readout_slots.pkl")
    ours, theirs = load_obj("out/rollout_readout_slots.pkl"), load_obj("jax/rollout_readout_slots.pkl")
    readout = load_obj(f"{data}/readout_slots.pkl")
    assert set(ours) == {"train", "val"}
    for split in ours:
        for n, s in ours[split].items():
            assert s.shape == (VIDEO_LEN, S, D)
            np.testing.assert_array_equal(s[:OBS], readout[split][n][:OBS])
            np.testing.assert_allclose(s, theirs[split][n], rtol=0, atol=1e-4)
