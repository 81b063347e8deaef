"""Port vs JAX: ``cli/convert_reference_ckpt.py``.

Reference ``.pth`` files made from ``model_goldens.npz``'s ``sd/`` arrays
(captured from the reference modules, as tests/test_convert_cli.py makes
them) convert and reproduce the goldens' outputs, at the goldens'
tolerances of tests/test_torch_savi.py, test_torch_steve.py and
test_torch_vqa.py. A ``.ckpt.pkl`` written by the JAX trainer, optax state
and all, converts in a process where ``jax``, ``flax`` and ``optax`` cannot
be imported, and the converted SlotFormer rolls out as the JAX model does
(1e-5: float32 on both sides). The coverage report, the shape refusal and
the refusals of JAX's ``load_checkpoint`` are each tested.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from slotformer_tpu.methods import build_method as jax_build_method
from slotformer_tpu.models import build_model as jax_build_model
from slotformer_tpu.runtime import BaseDataModule as JaxDataModule
from slotformer_tpu.runtime import load_params as jax_load_params
from slotformer_tpu_torch.cli.convert_reference_ckpt import main as convert
from slotformer_tpu_torch.models import build_model
from slotformer_tpu_torch.runtime import load_checkpoint, load_params
from torch_port_helpers import close, golden_group, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SAVI_CFG = """
from slotformer_tpu_torch.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    model = 'StoSAVi'
    resolution = (64, 64)
    input_frames = 4
    slot_dict = dict(num_slots=4, slot_size=16, slot_mlp_size=32,
                     num_iterations=2, kernel_mlp=True)
    enc_dict = dict(enc_channels=(3, 8, 8), enc_ks=5, enc_norm='',
                    enc_out_channels=16)
    dec_dict = dict(dec_channels=(16, 8, 8), dec_resolution=(16, 16),
                    dec_ks=5, dec_norm='')
    pred_dict = dict(pred_type='transformer', pred_rnn=True,
                     pred_num_layers=1, pred_num_heads=4, pred_ffn_dim=32)
    loss_dict = dict(use_post_recon_loss=True, kld_method='none')
"""

STEVE_CFG = """
from slotformer_tpu_torch.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    model = 'STEVE'
    resolution = (64, 64)
    input_frames = 2
    slot_dict = dict(num_slots=3, slot_size=16, slot_mlp_size=32,
                     num_iterations=2)
    dvae_dict = dict(down_factor=4, vocab_size=16, dvae_ckp_path='')
    enc_dict = dict(enc_channels=(3, 8, 8), enc_ks=5, enc_norm='',
                    enc_out_channels=16)
    dec_dict = dict(dec_num_layers=1, dec_num_heads=2, dec_d_model=16)
    pred_dict = dict(pred_type='transformer', pred_rnn=True,
                     pred_norm_first=True, pred_num_layers=1,
                     pred_num_heads=2, pred_ffn_dim=32, pred_sg_every=None)
    loss_dict = dict(use_img_recon_loss=False)
"""

ALOE_CFG = """
from slotformer_tpu_torch.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    model = 'CLEVRERAloe'
    vocab_file = {vocab_file!r}
    slot_size = 16
    n_sample_frames = 2
    max_n_objects = 2
    max_question_len = 4
    max_choice_len = 3
    transformer_dict = dict(
        input_len=2 * 3 + 7, input_dim=16, pos_enc='learnable',
        num_layers=2, num_heads=2, ffn_dim=32, norm_first=True,
        cls_mlp_size=8)
    vision_dict = dict(vision_dim=16)
    loss_dict = dict(use_mask_obj_loss=False)
"""

# one config for both packages: the JAX trainer writes, the port converts
SF_CFG = """
from {pkg}.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    model = 'SlotFormer'
    max_epochs = 1
    optimizer = 'Adam'
    lr = 1e-3
    train_batch_size = 4
    num_workers = 0
    resolution = (16, 16)
    n_sample_frames = 6
    input_frames = 3
    slot_dict = dict(num_slots=4, slot_size=16)
    dec_dict = dict(dec_channels=(16, 8), dec_resolution=(16, 16), dec_ks=3,
                    dec_ckp_path='')
    rollout_dict = dict(num_slots=4, slot_size=16, history_len=3, t_pe='sin',
                        d_model=16, num_layers=1, num_heads=2, ffn_dim=32)
    loss_dict = dict(rollout_len=3, use_img_recon_loss=False)
    slot_recon_loss_w = 1.0
"""


def _cfg(tmp_path, text, name):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _pth(tmp_path, sd, name="ref.pth", prefix=""):
    path = str(tmp_path / name)
    torch.save({"state_dict": {prefix + k: torch.from_numpy(np.asarray(v))
                               for k, v in sd.items()}}, path)
    return path


def _convert(tmp_path, cfg, src, capsys):
    out = str(tmp_path / "out.pth")
    convert(["--params", cfg, "--ref_ckpt", src, "--save_path", out])
    report = capsys.readouterr().out
    model = build_model(load_params(cfg), device="cpu")
    model.load_state_dict(load_checkpoint(out)["state_dict"])
    return model, report


# ------------------------------------------------- reference .pth -> port

def test_convert_stosavi_reference_pth(tmp_path, capsys):
    sd, ins, outs = golden_group("g_savi")
    model, report = _convert(tmp_path, _cfg(tmp_path, SAVI_CFG, "savi.py"),
                             _pth(tmp_path, sd), capsys)
    n = len(model.state_dict())
    assert f"mapped {n}/{n} tensors" in report and "WARNING" not in report
    assert "ignored 6 source tensors" in report  # prior_slot_layer.*
    img = np.transpose(ins["img"], (0, 1, 3, 4, 2))  # NCHW video -> NHWC
    with torch.no_grad():
        kd, ps, feats, _ = model.encode(t(img))
        rc = model.decode(t(ins["dec_slots"]))[0]
    close(feats, outs["encoder_out"], rtol=2e-3, atol=2e-4)
    close(ps, outs["post_slots"], rtol=5e-3, atol=5e-4)
    close(rc, np.transpose(outs["recon_combined"], (0, 2, 3, 1)),
          rtol=2e-3, atol=2e-4)


def test_convert_steve_reference_pth(tmp_path, capsys):
    sd, ins, outs = golden_group("g_stevefull")
    model, report = _convert(tmp_path, _cfg(tmp_path, STEVE_CFG, "steve.py"),
                             _pth(tmp_path, sd), capsys)
    assert "WARNING" not in report
    img = np.transpose(ins["img"], (0, 1, 3, 4, 2))
    with torch.no_grad():
        slots, masks, _, _ = model.encode(t(img))
    close(slots, outs["slots"], rtol=5e-3, atol=5e-4)
    close(masks, outs["masks"], rtol=5e-3, atol=5e-4)


def test_convert_aloe_reference_pth(tmp_path, capsys):
    """The reference's Aloe checkpoints hold the head under
    ``transformer_model.``; the golden holds the head itself."""
    sd, ins, outs = golden_group("g_aloe")
    vocab_file = str(tmp_path / "vocab.json")
    with open(vocab_file, "w") as f:
        json.dump({"q_vocab": [f"w{i}" for i in range(20)],
                   "a_vocab": [f"a{i}" for i in range(5)]}, f)
    cfg = _cfg(tmp_path, ALOE_CFG.format(vocab_file=vocab_file), "aloe.py")
    model, report = _convert(
        tmp_path, cfg, _pth(tmp_path, sd, prefix="transformer_model."), capsys)
    assert "WARNING" not in report
    mc_flag = ins["mc_flag"].astype(int)
    n_cls = len(ins["cls_q_tokens"])
    batch = {
        "video_emb": t(np.concatenate([ins["cls_video_emb"],
                                       ins["mc_video_emb"][mc_flag]])),
        "q_tokens": torch.from_numpy(np.concatenate(
            [ins["cls_q_tokens"], ins["mc_q_tokens"]]).astype(np.int64)),
        "q_pad_mask": torch.from_numpy(np.concatenate(
            [ins["cls_q_pad_mask"], ins["mc_q_pad_mask"]]).astype(bool)),
        "is_cls": torch.tensor([True] * n_cls + [False] * len(mc_flag)),
    }
    with torch.no_grad():
        got = model(batch)
    close(got["cls_answer_logits"][:n_cls], outs["cls_logits"])
    close(got["mc_answer_logits"][n_cls:], outs["mc_logits"])


def test_coverage_report_and_shape_refusal(tmp_path, capsys):
    sd, _, _ = golden_group("g_savi")
    cfg = _cfg(tmp_path, SAVI_CFG, "savi.py")
    missing = [k for k in sd if k.startswith("decoder.")]
    part = {k: v for k, v in sd.items() if k not in missing}
    model, report = _convert(tmp_path, cfg, _pth(tmp_path, part), capsys)
    n = len(model.state_dict())
    assert f"mapped {n - len(missing)}/{n} tensors" in report
    assert "WARNING" in report and missing[0] in report
    bad = dict(sd)
    k = next(k for k in sd if k.endswith("weight") and sd[k].ndim == 2)
    bad[k] = np.zeros((sd[k].shape[0] + 1, sd[k].shape[1]), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert(["--params", cfg, "--ref_ckpt", _pth(tmp_path, bad, "bad.pth"),
                 "--save_path", str(tmp_path / "x.pth")])
    extra = dict(sd, **{"head.weight": np.zeros(2, np.float32)})
    _, report = _convert(tmp_path, cfg, _pth(tmp_path, extra, "e.pth"), capsys)
    assert "ignored 7 source tensors" in report and "head.weight" in report


# ------------------------------------------------ JAX .ckpt.pkl -> port

def test_convert_jax_trainer_checkpoint_without_jax(tmp_path):
    jcfg = _cfg(tmp_path, SF_CFG.format(pkg="slotformer_tpu"), "jax_sf.py")
    pcfg = _cfg(tmp_path, SF_CFG.format(pkg="slotformer_tpu_torch"), "sf.py")
    params = jax_load_params(jcfg)
    slots = np.random.RandomState(0).randn(4, 6, 4, 16).astype(np.float32)
    model = jax_build_model(params)
    dm = JaxDataModule(params, [{"slots": s} for s in slots], None)
    method = jax_build_method(model=model, datamodule=dm, params=params,
                              ckp_path=str(tmp_path / "jax"))
    # the state setup_state builds (params, Adam's state, rng), jitted and
    # unsharded; the trainer's save_ckp writes it
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(model.init)({"params": key}, {"slots": slots})["params"]
    method.state = {"params": jparams,
                    "opt_state": jax.jit(method.optimizer.init)(jparams),
                    "rng": jax.random.PRNGKey(1)}
    method.it = 3
    method.save_ckp()
    method._join_ckp_writer()
    src = str(tmp_path / "jax" / "model_3.ckpt.pkl")
    with open(src, "rb") as f:
        assert b"optax" in f.read()  # the optimizer state is in the file
    out = str(tmp_path / "sf.pth")
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax'):\n"
            "    sys.modules[m] = None\n"
            "from slotformer_tpu_torch.cli.convert_reference_ckpt import main\n"
            f"main(['--params', {pcfg!r}, '--ref_ckpt', {src!r}, "
            f"'--save_path', {out!r}])\n"
            "assert not any(m.startswith(('jax', 'flax', 'optax', "
            "'slotformer_tpu.')) for m, v in sys.modules.items() "
            "if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "WARNING" not in proc.stdout
    port = build_model(load_params(pcfg), device="cpu")
    port.load_state_dict(load_checkpoint(out)["state_dict"])
    want = model.apply({"params": method.state["params"]}, slots[:, :3], 3,
                       method="rollout")
    with torch.no_grad():
        got = port.rollout(t(slots[:, :3]), 3)
    close(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def _pkl(tmp_path, payload, name):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return path


def test_jax_checkpoint_refusals(tmp_path):
    """As the JAX package's ``load_checkpoint``: a newer ``format_version``,
    and an unstamped file that holds deconvolutions."""
    cfg = _cfg(tmp_path, SF_CFG.format(pkg="slotformer_tpu_torch"), "sf.py")
    newer = _pkl(tmp_path, {"state_dict": {}, "format_version": 3}, "v3.pkl")
    with pytest.raises(ValueError, match="format_version 3"):
        convert(["--params", cfg, "--ref_ckpt", newer,
                 "--save_path", str(tmp_path / "x.pth")])
    tree = {"decoder": {"deconv_0": {"ConvTranspose_0": {
        "kernel": np.zeros((3, 3, 8, 16), np.float32)}}}}
    old = _pkl(tmp_path, {"state_dict": tree, "step": 0}, "v1.pkl")
    with pytest.raises(ValueError, match="predates the format_version"):
        convert(["--params", cfg, "--ref_ckpt", old,
                 "--save_path", str(tmp_path / "x.pth")])
