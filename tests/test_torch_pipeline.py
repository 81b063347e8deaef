"""The port's slice as a whole: StoSAVi encode -> SlotFormer rollout ->
decode against JAX, the extraction and rollout CLIs, and the port's
independence from JAX.

Tolerance: 1e-4 abs for the chained slice, whose float32 differences pass
through the encoder's recurrence and then the autoregressive rollout;
1e-4 abs for the rollout CLI against the reference-executed golden, as
tests/test_rollout_e2e_parity.py holds the JAX CLI.
"""

import os
import pickle
import re
import subprocess
import sys
import types

import numpy as np
import torch

from slotformer_tpu.cli.extract_slots import extract_video_slots as jax_extract
from slotformer_tpu.models.savi import StoSAVi as JaxStoSAVi
from slotformer_tpu.models.slotformer import SlotFormer as JaxSlotFormer
from slotformer_tpu_torch.cli import extract_slots, rollout_slots
from slotformer_tpu_torch.datasets import SyntheticVideoDataset
from slotformer_tpu_torch.models.savi import StoSAVi
from slotformer_tpu_torch.models.slotformer import SlotFormer
from slotformer_tpu_torch.runtime.weights import from_jax_params
from torch_port_helpers import GOLDEN, close, jax_init, randn, rng, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_ATOL = 1e-4

SAVI = dict(
    resolution=(16, 16),
    slot_dict=dict(num_slots=4, slot_size=16, slot_mlp_size=32,
                   num_iterations=2, kernel_mlp=False),
    enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=5, enc_out_channels=16,
                  enc_norm=""),
    dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4), dec_ks=5,
                  dec_norm=""),
    pred_dict=dict(pred_type="mlp", pred_rnn=False, pred_norm_first=True),
    loss_dict=dict(use_post_recon_loss=True, kld_method="var-0.01"),
)
SF = dict(
    resolution=(16, 16),
    slot_dict=dict(num_slots=4, slot_size=16),
    dec_dict=SAVI["dec_dict"],
    rollout_dict=dict(num_slots=4, slot_size=16, history_len=4, t_pe="sin",
                      slots_pe="", d_model=32, num_layers=2, num_heads=4,
                      ffn_dim=64, norm_first=True),
    loss_dict=dict(rollout_len=3, use_img_recon_loss=False),
)


def _port(cls, cfg, params, kind):
    port = cls(**cfg).eval()
    port.load_state_dict(from_jax_params(params, kind,
                                         types.SimpleNamespace(**cfg)))
    return port


def test_slice_matches_jax():
    """Encode a clip, roll its slots out with SlotFormer (decoder grafted
    from the StoSAVi, as the reference trains it) and decode, on both
    sides from the same weights and noise."""
    r = rng(0)
    img = np.tanh(randn(r, 2, 6, 16, 16, 3))
    eps = randn(r, 2, 6, 4, 16)
    jsavi, jsf = JaxStoSAVi(**SAVI), JaxSlotFormer(**SF)
    p_savi = jax_init(jsavi, {"img": img, "sample_eps": eps})
    p_sf = jax_init(jsf, {"slots": np.zeros((1, 7, 4, 16), np.float32)})
    p_sf["decoder"] = p_savi["decoder"]

    _, slots, _, _, _ = jsavi.apply({"params": p_savi}, img, method="encode",
                                    sample_eps=eps)
    want = jsf.apply({"params": p_sf}, slots, 5, True, False, method="rollout")

    savi = _port(StoSAVi, SAVI, p_savi, "StoSAVi")
    sf = _port(SlotFormer, SF, p_sf, "SlotFormer")
    with torch.no_grad():
        got_slots = savi.encode(t(img), sample_eps=t(eps))[1]
        got = sf.rollout(got_slots, 5, decode=True, with_gt=False)
    close(got_slots, slots, atol=SLICE_ATOL)
    for key in ("slots", "recon_combined", "masks"):
        close(got[key], want[key], atol=SLICE_ATOL)


def test_extract_video_slots_matches_jax_chunked():
    """Deterministic StoSAVi (no noise), 7 frames in chunks of 3: carry-over
    across chunks, the padded tail chunk and a short last batch."""
    cfg = dict(SAVI, loss_dict=dict(use_post_recon_loss=True,
                                    kld_method="none"))
    ds = SyntheticVideoDataset("val", num_videos=3, video_len=7,
                               resolution=(16, 16))
    jmod = JaxStoSAVi(**cfg)
    params = jax_init(jmod, {"img": np.zeros((1, 2, 16, 16, 3), np.float32)})
    want = jax_extract(jmod, params, ds, batch_size=2, chunk_len=3)
    port = _port(StoSAVi, cfg, params, "StoSAVi")
    got = extract_slots.extract_video_slots(port, ds, batch_size=2, chunk_len=3)
    assert sorted(got) == sorted(want) == sorted(ds.files)
    for name in want:
        assert got[name].shape == (7, 4, 16) and got[name].dtype == np.float32
        close(got[name], want[name], atol=SLICE_ATOL)


def test_extract_video_slots_is_seeded():
    ds = SyntheticVideoDataset("val", num_videos=2, video_len=5,
                               resolution=(16, 16))
    torch.manual_seed(0)
    model = StoSAVi(**SAVI).eval()
    a, b, c = (extract_slots.extract_video_slots(model, ds, batch_size=2,
                                                 chunk_len=2, seed=s)
               for s in (3, 3, 4))
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
        assert np.all(np.isfinite(a[name]))
    assert not np.array_equal(a[name], c[name])


def _write_config(path, text):
    path.write_text(text)
    return str(path)


def test_extract_cli_writes_the_slots_pickle(tmp_path):
    cfg = _write_config(tmp_path / "tiny_savi_params.py", f'''
from slotformer_tpu_torch.runtime.params import BaseParams

class SlotFormerParams(BaseParams):
    model = "StoSAVi"
    dataset = "synthetic"
    resolution = (16, 16)
    input_frames = 2
    n_sample_frames = 2
    frame_offset = 1
    video_len = 5
    num_videos_train = 3
    num_videos_val = 2
    slot_dict = {SAVI["slot_dict"]!r}
    enc_dict = {SAVI["enc_dict"]!r}
    dec_dict = {SAVI["dec_dict"]!r}
    pred_dict = {SAVI["pred_dict"]!r}
    loss_dict = {SAVI["loss_dict"]!r}
''')
    torch.manual_seed(0)
    weight = tmp_path / "ckpt" / "model.pth"
    weight.parent.mkdir()
    torch.save({"state_dict": StoSAVi(**SAVI).state_dict()}, weight)
    save = tmp_path / "out" / "slots.pkl"
    extract_slots.main(["--params", cfg, "--weight", str(weight),
                        "--save_path", str(save), "--batch_size", "2",
                        "--chunk_len", "2", "--device", "cpu"])
    with open(save, "rb") as f:
        out = pickle.load(f)
    assert sorted(out) == ["train", "val"]
    assert len(out["train"]) == 3 and len(out["val"]) == 2
    for vid in out["val"].values():
        assert vid.shape == (5, 4, 16) and vid.dtype == np.float32
    link = weight.parent / "slots.pkl"
    assert link.is_symlink() and os.path.realpath(link) == os.path.realpath(save)


def test_rollout_cli_reproduces_reference_golden(tmp_path):
    """The reference's rollout flow (frame_offset 3, three interleaved
    phases), executed in torch and stored in rollout_golden.npz, from its
    own checkpoint: the port loads it as it is."""
    text = open(os.path.join(GOLDEN, "rollout_cfg.py")).read()
    text = text.replace("from slotformer_tpu.runtime import BaseParams",
                        "from slotformer_tpu_torch.runtime.params import BaseParams")
    text = re.sub(r"_HERE = .*", f"_HERE = {GOLDEN!r}", text)
    cfg = _write_config(tmp_path / "rollout_cfg.py", text)
    sd = {k[3:]: torch.from_numpy(v) for k, v in
          np.load(os.path.join(GOLDEN, "testvp_golden.npz")).items()
          if k.startswith("sd/")}
    weight = tmp_path / "ref_sf.pth"
    torch.save({"state_dict": sd}, weight)
    save = tmp_path / "out" / "rollout_slots.pkl"
    rollout_slots.main(["--task", "clevrer", "--params", cfg, "--weight",
                        str(weight), "--save_path", str(save),
                        "--batch_size", "2", "--obs_frames", "12",
                        "--target_len", "18", "--device", "cpu"])
    with open(save, "rb") as f:
        ours = pickle.load(f)
    with open(os.path.join(GOLDEN, "rollout_slots_in.pkl"), "rb") as f:
        inputs = pickle.load(f)
    gold = np.load(os.path.join(GOLDEN, "rollout_golden.npz"))
    assert len(gold.files) == 7
    for k in gold.files:
        _, split, fn = k.split("/", 2)
        got = ours[split][fn]
        assert got.shape == (18, 5, 16)
        np.testing.assert_array_equal(got[:12], inputs[split][fn])
        np.testing.assert_allclose(got[12:], gold[k][12:], rtol=1e-4,
                                   atol=1e-4)
    assert (tmp_path / "rollout_slots.pkl").is_symlink()


def _port_files():
    root = os.path.join(REPO, "slotformer_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(root):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_nothing_of_jax():
    banned = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|slotformer_tpu)(?:[.\s,]|$)")
    offenders = [f"{path}:{i}: {line.strip()}"
                 for path in _port_files()
                 for i, line in enumerate(open(path), 1) if banned.match(line)]
    assert not offenders, offenders


def test_port_imports_with_jax_unimportable():
    code = """
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "slotformer_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
import slotformer_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(slotformer_tpu_torch.__path__,
                                              "slotformer_tpu_torch.")]
for m in mods + ["chip_smoke"]:
    importlib.import_module(m)
print(len(mods))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_clevrer_videos_match_jax_and_extract(tmp_path):
    """Two 128-frame mp4s in CLEVRER's val layout: the port decodes them as
    the JAX dataset does, and the extraction CLI writes all three splits."""
    from slotformer_tpu.datasets.clevrer import CLEVRERDataset as JaxCLEVRER
    from slotformer_tpu.datasets.utils import BaseTransforms
    from slotformer_tpu.runtime.io import save_video
    from slotformer_tpu_torch.datasets import CLEVRERDataset

    r = rng(7)
    vdir = tmp_path / "videos" / "val" / "video_10000-11000"
    vdir.mkdir(parents=True)
    for vid in (10000, 10001):
        frames = (r.random((128, 24, 32, 3)) * 255).astype(np.uint8)
        save_video(frames, str(vdir / f"video_{vid:05d}.mp4"))
    port = CLEVRERDataset(str(tmp_path), (16, 16), split="val", frame_offset=4)
    ref = JaxCLEVRER(str(tmp_path), BaseTransforms((16, 16)), split="val",
                     frame_offset=4)
    assert [os.path.basename(f) for f in port.files] == \
        [os.path.basename(f) for f in ref.files] == ["video_10000.mp4", "video_10001.mp4"]
    for i in range(2):
        got = port.get_video(i)["video"]
        assert got.shape == (32, 16, 16, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref.get_video(i)["video"])

    cfg = _write_config(tmp_path / "tiny_clevrer_params.py", f'''
from slotformer_tpu_torch.runtime.params import BaseParams

class SlotFormerParams(BaseParams):
    model = "StoSAVi"
    dataset = "clevrer"
    data_root = {str(tmp_path)!r}
    resolution = (16, 16)
    input_frames = 2
    frame_offset = 4
    slot_dict = {SAVI["slot_dict"]!r}
    enc_dict = {SAVI["enc_dict"]!r}
    dec_dict = {SAVI["dec_dict"]!r}
    pred_dict = {SAVI["pred_dict"]!r}
    loss_dict = {SAVI["loss_dict"]!r}
''')
    torch.manual_seed(0)
    weight = tmp_path / "model.pth"
    torch.save({"state_dict": StoSAVi(**SAVI).state_dict()}, weight)
    save = tmp_path / "out" / "clevrer_slots.pkl"
    extract_slots.main(["--params", cfg, "--weight", str(weight),
                        "--save_path", str(save), "--chunk_len", "12",
                        "--device", "cpu"])
    with open(save, "rb") as f:
        out = pickle.load(f)
    assert sorted(out) == ["test", "train", "val"]
    assert not out["train"] and not out["test"]
    assert sorted(out["val"]) == ["video_10000.mp4", "video_10001.mp4"]
    assert all(v.shape == (32, 4, 16) for v in out["val"].values())
