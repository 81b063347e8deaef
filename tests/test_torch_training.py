"""Port vs JAX: the StoSAVi training slice.

The StoSAVi losses and every parameter's gradient, the reference's 20-step
noise-matched trajectory (golden ``g_savitraj``), the optimizer stack and LR
schedule, the data loader's order, CLEVRER clip sampling, the trainer's
``fit`` against the JAX ``BaseMethod``, its resume/checkpoint/AMP behaviour
(mirroring tests/test_trainer.py) and the training CLI.

Inputs, weights and noise are the same numpy arrays on both sides.
Tolerances: losses rtol 1e-5 and gradients 1e-4 rel for one step (float32
on both sides, summed in different orders through 3 recurrent frame steps);
trajectories rtol 5e-3, the tolerance of the JAX package's own g_savitraj
test (tests/test_golden_parity.py:451-452). The port keeps the reference's
two GRU r/z bias vectors where JAX keeps one (their sum), so both port
vectors get JAX's gradient, and under Adam the port follows the reference's
trajectory, not JAX's.
"""

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import optax
import pytest
import torch

from slotformer_tpu.runtime import torch_compat as tc
from slotformer_tpu_torch.cli import train as train_cli
from slotformer_tpu_torch.methods import build_method
from slotformer_tpu_torch.models import build_model
from slotformer_tpu_torch.models.savi import StoSAVi
from slotformer_tpu_torch.runtime import (
    BaseDataModule,
    BaseParams,
    DataLoader,
    build_optimizer,
    cosine_anneal,
    cosine_annealing_warmup,
    latest_checkpoint,
    load_checkpoint,
)
from slotformer_tpu_torch.runtime import method as method_mod
from slotformer_tpu_torch.runtime.weights import from_jax_params
from slotformer_tpu.models.savi import StoSAVi as JaxStoSAVi
from test_torch_savi import CFG
from torch_port_helpers import close, golden_group, randn, rng, state_dict, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_RTOL = 5e-3
KLD_W = 1e-4


def _pair(B=2, T=3, seed=0):
    """(jax model, its random params, port model with the same weights,
    img, sample_eps); the JAX init is jitted, which is several times faster
    than running it eagerly."""
    r = rng(seed)
    img = np.tanh(randn(r, B, T, *CFG["resolution"], 3))
    eps = randn(r, B, T, CFG["slot_dict"]["num_slots"],
                CFG["slot_dict"]["slot_size"])
    jmod = JaxStoSAVi(**CFG)
    variables = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                   {"img": img, "sample_eps": eps})
    params = jax.tree.map(np.asarray, dict(variables["params"]))
    port = StoSAVi(**CFG).eval()
    port.load_state_dict(from_jax_params(params, "StoSAVi",
                                         types.SimpleNamespace(**CFG)))
    return jmod, params, port, img, eps


def _grads_as_port(jax_grads, cfg, port):
    """JAX gradients in the port's names and layouts; both GRU r/z bias
    vectors take the gradient of JAX's single (summed) one."""
    want = from_jax_params(jax.tree.map(np.asarray, jax_grads), "StoSAVi",
                           types.SimpleNamespace(**cfg))
    D = cfg["slot_dict"]["slot_size"]
    for name, _ in port.named_parameters():
        if name.endswith("gru.bias_hh"):
            want[name][:2 * D] = want[name.replace("bias_hh", "bias_ih")][:2 * D]
    return want


def test_train_and_eval_losses_and_gradients_match_jax():
    jmod, params, port, img, eps = _pair(seed=10)
    batch = {"img": img, "sample_eps": eps}

    def loss_fn(p):
        losses = jmod.apply({"params": p}, batch, method="train_loss")
        return losses["post_recon_loss"] + KLD_W * losses["kld_loss"], losses

    @jax.jit
    def jax_side(p):
        return (jax.value_and_grad(loss_fn, has_aux=True)(p),
                jmod.apply({"params": p}, batch, method="eval_loss"))

    ((_, jl), jg), je = jax_side(params)

    tb = {"img": t(img), "sample_eps": t(eps)}
    port.train()
    pl = port.train_loss(tb)
    (pl["post_recon_loss"] + KLD_W * pl["kld_loss"]).backward()
    port.eval()
    with torch.no_grad():
        pe = port.eval_loss(tb)
    assert sorted(pl) == sorted(jl) == ["kld_loss", "post_recon_loss"]
    for k in jl:
        close(pl[k], jl[k], rtol=1e-5, atol=0)
        close(pe[k], je[k], rtol=1e-5, atol=0)
    want = _grads_as_port(jg, CFG, port)
    for name, p in port.named_parameters():
        scale = float(np.abs(want[name].numpy()).max())
        close(p.grad, want[name], rtol=1e-4, atol=1e-4 * scale + 1e-9)


def test_kld_none_is_zero_and_deterministic():
    cfg = dict(CFG, loss_dict=dict(use_post_recon_loss=True, kld_method="none"))
    port = StoSAVi(**cfg).train()
    img = t(np.tanh(np.random.default_rng(0).standard_normal((1, 2, 16, 16, 3))))
    a, b = port.train_loss({"img": img}), port.train_loss({"img": img})
    assert float(a["kld_loss"]) == 0.0
    assert torch.equal(a["post_recon_loss"], b["post_recon_loss"])


def test_golden_g_savitraj_trajectory():
    """20 noise-matched Adam(3e-4) steps of the reference's StoSAVi recipe
    (kld var-0.01, kld weight 1e-4) against the reference's own kld/recon
    trajectory."""
    sd, ins, outs = golden_group("g_savitraj")
    port = StoSAVi(
        resolution=(64, 64), clip_len=3,
        slot_dict=dict(num_slots=3, slot_size=16, slot_mlp_size=32,
                       num_iterations=2, kernel_mlp=True),
        enc_dict=dict(enc_channels=(3, 8), enc_ks=3, enc_norm="",
                      enc_out_channels=16),
        dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(16, 16),
                      dec_ks=3, dec_norm=""),
        pred_dict=dict(pred_type="mlp", pred_rnn=False, pred_norm_first=True),
        loss_dict=dict(use_post_recon_loss=True, kld_method="var-0.01"),
    )
    port.load_state_dict(state_dict(sd))
    port.train()
    opt = torch.optim.Adam(port.parameters(), lr=3e-4)
    img = t(np.transpose(ins["img"], (0, 1, 3, 4, 2)))  # NCHW video -> NHWC
    klds, recons = [], []
    for eps in ins["eps"]:  # [T, B, S, D] per step
        losses = port.train_loss(
            {"img": img, "sample_eps": t(np.transpose(eps, (1, 0, 2, 3)))})
        opt.zero_grad()
        (losses["post_recon_loss"] + KLD_W * losses["kld_loss"]).backward()
        opt.step()
        klds.append(losses["kld_loss"].item())
        recons.append(losses["post_recon_loss"].item())
    rel = max(np.abs(np.array(recons) / outs["recon"] - 1).max(),
              np.abs(np.array(klds) / outs["kld"] - 1).max())
    print(f"g_savitraj: worst rel diff over 20 steps {rel:.3e}")
    np.testing.assert_allclose(recons, outs["recon"], rtol=TRAJ_RTOL, atol=1e-5)
    np.testing.assert_allclose(klds, outs["kld"], rtol=TRAJ_RTOL, atol=1e-4)


# ------------------------------------------------------------- optimizer


class _Toy(torch.nn.Module):
    def __init__(self, w, b, dec):
        super().__init__()
        self.w = torch.nn.Parameter(t(w))
        self.b = torch.nn.Parameter(t(b))
        self.trans_decoder = torch.nn.Parameter(t(dec))


@pytest.mark.parametrize("opt", [
    dict(optimizer="Adam", clip_grad=0.05),
    dict(optimizer="Adam", weight_decay=0.1, clip_grad=-1),  # -> AdamW
    dict(optimizer="AdamW", weight_decay=0.01, clip_grad=1.0, dec_lr=3e-3),
    dict(optimizer="SGD", weight_decay=0.5),  # coupled decay, not AdamW
])
def test_optimizer_stack_matches_optax(opt):
    """Same params and gradient sequence: the port's clip -> schedule ->
    update equals the JAX package's optax chain at every step, so the LR at
    every step of the horizon is JAX's cosine_annealing_warmup."""
    from slotformer_tpu.runtime.schedules import build_optimizer as jax_build

    cfg = BaseParams(lr=1e-2, warmup_steps_pct=0.25, **opt)
    steps = 8
    r = np.random.default_rng(0)
    p0 = {"w": r.standard_normal((3, 4)).astype(np.float32),
          "b": r.standard_normal(4).astype(np.float32),
          "trans_decoder": r.standard_normal(5).astype(np.float32)}
    tx = jax_build(cfg, steps)
    jp, state = dict(p0), tx.init(p0)
    toy = _Toy(p0["w"], p0["b"], p0["trans_decoder"])
    port_opt = build_optimizer(cfg, toy, steps)
    assert len(port_opt.optimizer.param_groups) == (2 if "dec_lr" in opt else 1)
    if opt["optimizer"] == "SGD":
        assert isinstance(port_opt.optimizer, torch.optim.SGD)
    for step in range(steps):
        grads = {k: (r.standard_normal(v.shape) * 0.2).astype(np.float32)
                 for k, v in p0.items()}
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, p in toy.named_parameters():
            p.grad = t(grads[name])
        norm = port_opt.step(step)
        port_opt.zero_grad()
        close(norm, optax.global_norm(grads), rtol=1e-6)
        for name, p in toy.named_parameters():
            # O(1) float32 params: Adam's division amplifies last-bit noise
            close(p, jp[name], rtol=1e-5, atol=1e-6)
    if opt["optimizer"] == "SGD":
        assert not port_opt.optimizer.state or all(
            "exp_avg" not in s for s in port_opt.optimizer.state.values())


def test_schedules_match_jax_and_frozen_prefixes():
    from slotformer_tpu.runtime.schedules import cosine_anneal as jax_anneal
    from slotformer_tpu.runtime.schedules import (
        cosine_annealing_warmup as jax_sched,
    )

    for total, warm in ((20, 3), (7, 0), (1, 0)):
        ps, js = (f(total, 1e-3, 1e-5, warm) for f in (cosine_annealing_warmup,
                                                       jax_sched))
        for step in range(total + 3):
            assert ps(step) == pytest.approx(float(js(step)), rel=1e-6)
    for step in (0, 25, 50, 99, 150):
        assert cosine_anneal(step, 1.0, 0.1, 10, 100) == pytest.approx(
            jax_anneal(step, 1.0, 0.1, 10, 100), rel=1e-12)

    toy = _Toy(np.ones((2, 2)), np.ones(2), np.ones(3))
    opt = build_optimizer(BaseParams(lr=1e-3), toy, 10, frozen_prefixes=("b",))
    assert not toy.b.requires_grad
    assert all(p is not toy.b for p in opt.params)


# ------------------------------------------------------------------ data


class _Toy1D:
    def __init__(self, n, touched=None):
        self.n, self.touched = n, touched

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.touched is not None:
            self.touched.append(i)
        return {"x": np.full((2,), i, np.float32), "idx": i}


def test_dataloader_order_matches_jax_and_iter_from_skips():
    from slotformer_tpu.runtime.datamodule import DataLoader as JaxLoader

    for epoch in (0, 3):
        got, want = [], []
        for cls, out in ((DataLoader, got), (JaxLoader, want)):
            dl = cls(_Toy1D(22), batch_size=4, shuffle=True, drop_last=True,
                     seed=7, num_workers=2)
            dl.set_epoch(epoch)
            out += [b["idx"].tolist() for b in dl]
        assert got == want and len(got) == 5
    touched = []
    dl = DataLoader(_Toy1D(20, touched), batch_size=4, shuffle=True,
                    drop_last=True, seed=3, num_workers=0)
    dl.set_epoch(1)
    full = [b["idx"].tolist() for b in dl]
    touched.clear()
    tail = [b["idx"].tolist() for b in dl.iter_from(3)]
    assert tail == full[3:] and len(touched) == 4 * len(tail)


def test_clevrer_clips_match_jax(tmp_path):
    """Clip sampling and reading over an mp4 and a frame directory, train
    and val splits, against the JAX dataset."""
    from PIL import Image

    from slotformer_tpu.datasets.clevrer import CLEVRERDataset as JaxCLEVRER
    from slotformer_tpu.datasets.utils import BaseTransforms
    from slotformer_tpu.runtime.io import save_video
    from slotformer_tpu_torch.datasets import CLEVRERDataset

    r = np.random.default_rng(3)
    for split, first in (("train", 0), ("val", 10000)):
        vdir = tmp_path / "videos" / split / f"video_{first:05d}-{first + 1000:05d}"
        vdir.mkdir(parents=True)
        frames = (r.random((12, 24, 32, 3)) * 255).astype(np.uint8)
        save_video(frames, str(vdir / f"video_{first:05d}.mp4"))
        fdir = vdir / f"video_{first + 1:05d}"
        fdir.mkdir()
        for i, f in enumerate((r.random((12, 24, 32, 3)) * 255).astype(np.uint8)):
            Image.fromarray(f).save(fdir / f"{i:06d}.jpg")
        kw = dict(split=split, video_len=12, n_sample_frames=3, frame_offset=2)
        port = CLEVRERDataset(str(tmp_path), (16, 16), **kw)
        ref = JaxCLEVRER(str(tmp_path), BaseTransforms((16, 16)), **kw)
        assert port.valid_idx == ref.valid_idx and len(port) == len(ref)
        for i in range(len(port)):
            got, want = port[i], ref[i]
            assert not got["error_flag"] and got["img"].shape == (3, 16, 16, 3)
            np.testing.assert_array_equal(got["img"], want["img"])


# --------------------------------------------------------------- trainer


class _Video:
    """Moving-square clips, NHWC in [-1, 1] (tests/test_trainer.py)."""

    def __init__(self, n=12, t=3, res=16, seed=0):
        self.n, self.t, self.res = n, t, res
        self.pos = np.random.default_rng(seed).integers(2, res - 6, size=(n, 2))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        vid = -np.ones((self.t, self.res, self.res, 3), np.float32)
        y, x = self.pos[i]
        for k in range(self.t):
            c = (x + k) % (self.res - 4)
            vid[k, y:y + 4, c:c + 4, 0] = 1.0
        return {"img": vid, "data_idx": i}


TRAIN = dict(
    model="StoSAVi", max_epochs=1, save_interval=1.0, eval_interval=1,
    print_iter=1, optimizer="Adam", lr=3e-3, clip_grad=0.05,
    warmup_steps_pct=0.1, train_batch_size=4, val_batch_size=4, num_workers=0,
    resolution=(16, 16), input_frames=3, post_recon_loss_w=1.0,
    kld_loss_w=KLD_W, slot_dict=CFG["slot_dict"], enc_dict=CFG["enc_dict"],
    dec_dict=CFG["dec_dict"], pred_dict=CFG["pred_dict"],
    loss_dict=dict(use_post_recon_loss=True, kld_method="var-0.01"))


def _method(tmp_path, name="ckp", n=12, val=True, use_fp16=False, seed=0,
            **overrides):
    params = BaseParams(**{**TRAIN, **overrides})
    dm = BaseDataModule(params, _Video(n), _Video(4, seed=1) if val else None)
    torch.manual_seed(seed)
    model = build_model(params, device="cpu")
    return build_method(model=model, datamodule=dm, params=params,
                        ckp_path=str(tmp_path / name), use_fp16=use_fp16)


def _train_log(method):
    out = []
    orig = method._log
    method._log = lambda rec: (out.append(rec), orig(rec))
    return out


def test_fit_matches_jax_base_method(tmp_path):
    """3 steps of fit on both sides from the same initial weights, with the
    same batches, kld off (deterministic): the loss trajectories agree."""
    from slotformer_tpu.methods import build_method as jax_build_method
    from slotformer_tpu.models import build_model as jax_build_model
    from slotformer_tpu.runtime import BaseDataModule as JaxDM
    from slotformer_tpu.runtime import BaseParams as JaxParams

    over = dict(loss_dict=dict(use_post_recon_loss=True, kld_method="none"))
    jparams = JaxParams(**{**TRAIN, **over})
    jm = jax_build_method(model=jax_build_model(jparams),
                          datamodule=JaxDM(jparams, _Video(12), None),
                          params=jparams, ckp_path=str(tmp_path / "jax"))
    # jm.setup_state() with the model's init jitted (eager init takes ~10 s)
    from slotformer_tpu.parallel import replicate

    init = jax.jit(jm.model.init)(
        jm._init_rngs(), next(iter(jm.train_loader)))["params"]
    jm.state = replicate(jm.mesh, {"params": init,
                                   "opt_state": jm.optimizer.init(init),
                                   "rng": jax.random.PRNGKey(jm.seed + 1)})
    init = jax.device_get(init)
    jlog = _train_log(jm)
    jm.fit(san_check_val_step=0)

    pm = _method(tmp_path, val=False, **over)
    pm.model.load_state_dict(from_jax_params(
        init, "StoSAVi", types.SimpleNamespace(**TRAIN)))
    plog = _train_log(pm)
    pm.fit(san_check_val_step=0)
    want = [r["post_recon_loss"] for r in jlog if r["phase"] == "train"]
    got = [r["post_recon_loss"] for r in plog if r["phase"] == "train"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=TRAJ_RTOL)


def test_resume_roundtrip_and_mid_epoch_resume(tmp_path):
    """A mid-epoch checkpoint (save_interval 0.5) resumed in a fresh method
    skips the consumed batches, ends at exactly total_steps, and, with the
    optimizer state and the noise generator restored, reproduces the
    uninterrupted run's weights."""
    m1 = _method(tmp_path, "a", n=16, max_epochs=2, save_interval=0.5)
    m1.fit(san_check_val_step=0)
    assert m1.it == m1.total_steps == 8
    ck = load_checkpoint(os.path.join(str(tmp_path / "a"), "model_8.pth"))
    assert ck["it"] == 8 and ck["epoch"] == 1
    for k, v in m1.model.state_dict().items():
        assert torch.equal(ck["state_dict"][k], v)

    m2 = _method(tmp_path, "b", n=16, max_epochs=2, save_interval=0.5, seed=1)
    m2.fit(resume_from=str(tmp_path / "a" / "model_2.pth"),
           san_check_val_step=0)
    assert m2.it == m1.it
    for (k, a), b in zip(m1.model.state_dict().items(),
                         m2.model.state_dict().values()):
        close(b, a.numpy(), rtol=1e-5, atol=1e-7)
    assert latest_checkpoint(str(tmp_path / "b")).endswith("model_8.pth")


def test_resume_skips_setup_state(tmp_path, monkeypatch):
    m1 = _method(tmp_path, "c", n=8)
    m1.fit(san_check_val_step=0)
    m2 = _method(tmp_path, "c", n=8)

    def no_setup(*a, **kw):
        raise AssertionError("setup_state must be skipped on resume")

    monkeypatch.setattr(m2, "setup_state", no_setup)
    m2.fit(resume_from=latest_checkpoint(str(tmp_path / "c")),
           san_check_val_step=0)  # already at max steps
    assert m2.it == m1.it == 2


def test_failed_async_ckpt_write_raises(tmp_path, monkeypatch):
    method = _method(tmp_path, "d", n=8)

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(method_mod, "save_checkpoint", boom)
    method.save_ckp()
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        method._join_ckp_writer()
    method._join_ckp_writer()  # consumed once; a later join is clean


def test_bf16_autocast_and_grad_accum(tmp_path):
    """use_fp16 (bf16 autocast, slot attention in float32) + accum_grad=2:
    finite losses, the weights move, one optimizer step per two loader
    steps, float32 master weights."""
    method = _method(tmp_path, "e", n=16, max_epochs=2, accum_grad=2,
                     use_fp16=True)
    before = {k: v.clone() for k, v in method.model.state_dict().items()}
    log = _train_log(method)
    method.fit(san_check_val_step=1)
    train = [r for r in log if r["phase"] == "train"]
    assert len(train) == 8 and all(np.isfinite(r["total_loss"]) for r in train)
    moved = max((v - before[k]).abs().max().item()
                for k, v in method.model.state_dict().items())
    assert moved > 1e-5
    steps = {int(s["step"]) for s in method.optimizer.optimizer.state.values()}
    assert steps == {4}
    assert all(p.dtype == torch.float32 for p in method.model.parameters())


def test_profile_steps_write_a_trace(tmp_path):
    """profile_steps (start, stop): a torch.profiler trace of those steps
    under <ckp_path>/profile, and training goes on to the end."""
    method = _method(tmp_path, "f", n=12, profile_steps=(1, 2))
    method.fit(san_check_val_step=0)
    assert method.it == 3
    with open(tmp_path / "f" / "profile" / "trace_2.json") as f:
        assert json.load(f)["traceEvents"]


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    """python -m slotformer_tpu_torch.cli.train --device cpu: the loss falls,
    the checkpoints read with weights_only=True and load into the JAX model
    through torch_compat (same slots), --auto_resume continues from the
    newest one, and without --device the CLI asks for CUDA."""
    cfg = tmp_path / "tiny_savi_params.py"
    cfg.write_text(
        "from slotformer_tpu_torch.runtime.params import BaseParams\n\n"
        "class SlotFormerParams(BaseParams):\n"
        + "".join(f"    {k} = {v!r}\n" for k, v in TRAIN.items())
        + "    dataset = 'synthetic'\n    num_videos_train = 8\n"
        "    num_videos_val = 2\n    video_len = 6\n    n_sample_frames = 3\n"
        "    frame_offset = 1\n    max_epochs = 3\n    save_interval = 0.5\n")
    ckp = tmp_path / "ckp"
    args = ["--params", str(cfg), "--ckp_path", str(ckp), "--device", "cpu"]
    res = subprocess.run([sys.executable, "-m", "slotformer_tpu_torch.cli.train",
                          *args], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    with open(ckp / "log.jsonl") as f:
        train = [r for r in map(json.loads, f) if r["phase"] == "train"]
    assert len(train) == 3 * 8 == train[-1]["step"]
    assert train[-1]["post_recon_loss"] < 0.9 * train[0]["post_recon_loss"]

    last = latest_checkpoint(str(ckp))
    assert last.endswith("model_24.pth")
    ck = torch.load(last, map_location="cpu", weights_only=True)
    assert sorted(ck) == ["epoch", "it", "optimizer", "rng", "state_dict"]
    sd = {k: v.numpy() for k, v in ck["state_dict"].items()}
    jparams = tc.stosavi(sd, n_convs=2, pred_dict=CFG["pred_dict"],
                         kernel_mlp=False, n_deconvs=2)
    cfg_kw = {k: TRAIN[k] for k in ("resolution", "slot_dict", "enc_dict",
                                    "dec_dict", "pred_dict", "loss_dict")}
    r = np.random.default_rng(5)
    img = np.tanh(r.standard_normal((2, 3, 16, 16, 3))).astype(np.float32)
    eps = r.standard_normal((2, 3, 4, 16)).astype(np.float32)
    _, want, _, _, _ = JaxStoSAVi(**cfg_kw).apply(
        {"params": jparams}, img, method="encode", sample_eps=eps)
    port = StoSAVi(**cfg_kw).eval()
    port.load_state_dict(ck["state_dict"])
    with torch.no_grad():
        got = port.encode(t(img), sample_eps=t(eps))[1]
    close(got, want, atol=1e-4)

    # a run cut after step 20: --auto_resume takes model_20 and trains 21-24
    os.remove(last)
    log = []
    orig = method_mod.BaseMethod._log
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(method_mod.BaseMethod, "_log",
                   lambda self, rec: (log.append(rec), orig(self, rec)))
        train_cli.main(args + ["--auto_resume", "--san_check_val_step", "0"])
    assert [r["step"] for r in log if r["phase"] == "train"] == [21, 22, 23, 24]
    assert os.path.isfile(last)
    with pytest.raises((AssertionError, RuntimeError)):  # no CUDA here
        train_cli.main(args[:-2] + ["--ckp_path", str(tmp_path / "cuda")])
