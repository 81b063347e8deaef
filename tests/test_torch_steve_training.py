"""Port vs JAX: the STEVE family's training (dVAE, STEVE, STEVESlotFormer).

``graft`` from the root of a source state_dict; the dVAE's gumbel
temperature schedule against the JAX ``dVAEMethod``; one train step's losses
and every gradient of each model against JAX on the same weights and inputs
(dropout off on both sides: JAX ``deterministic=True``, the port in
``eval()`` with gradients on; the dVAE on JAX's recorded gumbel draws; the
frozen subtrees held as the trainers hold them); the methods through
``build_method`` and ``fit`` (a port of tests/test_steve_training.py, which
is ``slow``, and its STEVESlotFormer counterpart); and the three training
stages chained through ``cli.train`` with ``--device cpu`` on a mini Physion
tree (tests/test_torch_physion.py's), tokens and slots made in between by
the port's CLIs.

Tolerances: losses rtol 1e-5; gradients rtol 1e-4 and atol 1e-4 of each
gradient's largest entry (float32 on both sides, summed in other orders;
STEVE's pass two recurrent frame steps of slot attention); the schedule
rel 1e-6.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from slotformer_tpu.methods import dVAEMethod as JaxDVAEMethod
from slotformer_tpu.models.dvae import dVAE as JaxDVAE
from slotformer_tpu.models.steve import STEVE as JaxSTEVE
from slotformer_tpu.models.steve_slotformer import STEVESlotFormer as JaxSTEVESF
from slotformer_tpu_torch.cli import extract_slots, tokenize_images
from slotformer_tpu_torch.cli import train as train_cli
from slotformer_tpu_torch.datasets import build_dataset
from slotformer_tpu_torch.methods import (STEVEMethod, STEVESlotFormerMethod,
                                          build_method, dVAEMethod)
from slotformer_tpu_torch.models import STEVE, STEVESlotFormer, build_model, dVAE
from slotformer_tpu_torch.runtime import (BaseDataModule, BaseParams, graft,
                                          latest_checkpoint, load_checkpoint,
                                          load_params, save_checkpoint)
from slotformer_tpu_torch.runtime.weights import from_jax_params
from test_torch_physion import (COMMON, DVAE_CFG, SF_CFG, STEVE_CFG,  # noqa: F401
                                _write_cfg, tree)
from test_torch_steve import (TINY_DVAE, init_both, jax_uniforms,  # noqa: F401
                              sf_cfg, steve_cfg)
from torch_port_helpers import close, randn, rng, t

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
RES = (16, 16)


# ------------------------------------------------------------------ graft

def test_graft_from_the_source_root():
    """``{'dvae': ''}``: ``dvae.encoder.0.m.weight`` <- ``encoder.0.m.weight``
    of a dVAE trainer's checkpoint; ``strict`` checks every source key."""
    torch.manual_seed(0)
    src = {k: torch.randn_like(v) for k, v in dVAE(vocab_size=16).state_dict().items()}
    dst = STEVE(**steve_cfg(RES)).state_dict()
    out = graft(dst, {"state_dict": src}, {"dvae": ""})
    assert sorted(out) == sorted(dst)
    for k, v in src.items():
        assert torch.equal(out["dvae." + k], v)
    for k, v in dst.items():
        if not k.startswith("dvae."):
            assert torch.equal(out[k], v)
    # a STEVE checkpoint grafts from its own dvae.* keys
    again = graft(dst, out, {"dvae": "dvae"})
    assert all(torch.equal(again[k], out[k]) for k in out if k.startswith("dvae."))
    extra = dict(src, **{"head.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="head.weight"):
        graft(dst, extra, {"dvae": ""})
    graft(dst, extra, {"dvae": ""}, strict=False)
    with pytest.raises(KeyError, match="encoder.0.m.weight"):
        graft(dst, {k: v for k, v in src.items() if k != "encoder.0.m.weight"},
              {"dvae": ""})


# ------------------------------------------------------------- schedule

def test_dvae_tau_schedule_matches_jax():
    """``tau`` at every step of the horizon, as the JAX ``dVAEMethod``
    computes it (defaults, the shipped Physion setting, another one)."""
    for total, over in ((40, {}),
                        (14, dict(init_tau=1.0, final_tau=0.1, tau_decay_pct=0.15)),
                        (50, dict(init_tau=2.0, final_tau=0.5, tau_decay_pct=0.5))):
        method = types.SimpleNamespace(params=BaseParams(**over), total_steps=total)
        got = [dVAEMethod.train_loss_kwargs(method, s)["tau"]
               for s in range(total + 2)]
        want = [float(JaxDVAEMethod.train_loss_kwargs(method, s)["tau"])
                for s in range(total + 2)]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert got[0] == over.get("init_tau", 1.0)
        assert got[-1] == pytest.approx(over.get("final_tau", 0.1))
        assert all(a >= b for a, b in zip(got, got[1:]))


# ------------------------------------------------------ one train step

def _port_grads(jax_grads, kind, cfg, port):
    """JAX gradients in the port's names; both torch GRU r/z bias vectors
    and both LSTM bias vectors take the gradient of JAX's single one."""
    want = from_jax_params(jax.tree.map(np.asarray, jax_grads), kind,
                           types.SimpleNamespace(**cfg))
    for name, p in port.named_parameters():
        if name.endswith("gru.bias_hh"):
            D = p.shape[0] // 3
            want[name][:2 * D] = want[name.replace("bias_hh", "bias_ih")][:2 * D]
        elif name.endswith("rnn.bias_hh_l0"):
            want[name] = want[name.replace("bias_hh", "bias_ih")]
    return want


def _freeze(port, frozen):
    """``requires_grad=False`` under the ``frozen`` top-level names, as
    ``build_optimizer`` sets it."""
    for name, p in port.named_parameters():
        if name.split(".")[0] in frozen:
            p.requires_grad_(False)


def _check_grads(port, want, frozen=()):
    """Every trained parameter's gradient against JAX's; JAX's gradients of
    the frozen subtrees are zero. A gradient that is zero in exact
    arithmetic (q's LayerNorm bias moves every slot's logit alike) is held
    to 1e-8."""
    n = 0
    for name, p in port.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            if name.split(".")[0] in frozen:
                assert not np.abs(want[name].numpy()).any(), name
            continue
        scale = float(np.abs(want[name].numpy()).max())
        close(p.grad, want[name], rtol=GRAD_RTOL, atol=GRAD_RTOL * scale + 1e-8)
        n += 1
    assert n > 0


def _stop(params, frozen):
    return {k: jax.lax.stop_gradient(v) if k in frozen else v
            for k, v in params.items()}


def test_dvae_train_step_matches_jax(jax_uniforms):
    """Frames as the loader gives them ([B, 1, H, W, 3]), tau mid-schedule,
    JAX's gumbel draws fed to the port."""
    img = np.tanh(randn(rng(20), 2, 1, *RES, 3))
    jmod = JaxDVAE(vocab_size=16)
    params, port = init_both(jmod, dVAE, "dVAE", dict(vocab_size=16),
                             {"img": img[:, 0]})
    tau, key = 0.55, jax.random.PRNGKey(3)

    def loss_fn(p):
        losses = jmod.apply({"params": p}, {"img": img}, tau=tau,
                            method="train_loss", rngs={"sample": key})
        return losses["recon_loss"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    u = jax_uniforms[-1].reshape(2, 1, 4, 4, 16)
    port.train()
    out = port({"img": t(img)}, tau=tau, uniform=t(u))
    loss = port.calc_train_loss({"img": t(img)}, out)["recon_loss"]
    loss.backward()
    close(loss, jl["recon_loss"], rtol=LOSS_RTOL, atol=0)
    _check_grads(port, _port_grads(jg, "dVAE", dict(vocab_size=16), port))


def test_steve_train_step_matches_jax():
    """The token loss through two frame steps (K1's plain version here) and
    the teacher-forced decoder; the dVAE frozen and tokenizing inside."""
    cfg = steve_cfg(RES)
    img = np.tanh(randn(rng(21), 2, 2, *RES, 3))
    jmod = JaxSTEVE(**cfg)
    params, port = init_both(jmod, STEVE, "STEVE", cfg, {"img": img})

    def loss_fn(p):
        p = _stop(p, ("dvae",))
        out = jmod.apply({"params": p}, {"img": img}, deterministic=True)
        losses = jmod.apply({"params": p}, {"img": img}, out,
                            method="calc_train_loss")
        return losses["token_recon_loss"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    _freeze(port, ("dvae",))
    out = port({"img": t(img)})  # eval(): dropout off, gradients on
    loss = port.calc_train_loss({}, out)["token_recon_loss"]
    loss.backward()
    close(loss, jl["token_recon_loss"], rtol=LOSS_RTOL, atol=0)
    _check_grads(port, _port_grads(jg, "STEVE", cfg, port), frozen=("dvae",))


def test_steve_slotformer_train_step_matches_jax():
    """The slot loss of 3 rollout steps from 2 burn-in frames; the token
    decoder and the dVAE frozen."""
    cfg = sf_cfg(RES)
    slots = randn(rng(22), 2, 5, 3, 16)
    jmod = JaxSTEVESF(**cfg)
    params, port = init_both(jmod, STEVESlotFormer, "STEVESlotFormer", cfg,
                             {"slots": slots})

    def loss_fn(p):
        p = _stop(p, ("dvae", "trans_decoder"))
        out = jmod.apply({"params": p}, {"slots": slots}, deterministic=True)
        losses = jmod.apply({"params": p}, {"slots": slots}, out,
                            method="calc_train_loss")
        return losses["slot_recon_loss"], losses

    (_, jl), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    _freeze(port, ("dvae", "decoder"))
    loss = port.calc_train_loss({}, port({"slots": t(slots)}))["slot_recon_loss"]
    loss.backward()
    close(loss, jl["slot_recon_loss"], rtol=LOSS_RTOL, atol=0)
    _check_grads(port, _port_grads(jg, "STEVESlotFormer", cfg, port),
                 frozen=("dvae", "decoder"))


# ------------------------------------------------------------ methods

TINY_TRAIN = dict(max_epochs=1, eval_interval=1, print_iter=1,
                  optimizer="Adam", warmup_steps_pct=0.1, train_batch_size=4,
                  val_batch_size=4, num_workers=0)


class _Clips:
    """Random clips: ``img`` [t, H, W, 3] (or ``slots`` [t, 3, 16])."""

    def __init__(self, n, frames, seed=0, slots=False):
        r = rng(seed)
        shape = (n, frames, 3, 16) if slots else (n, frames, *RES, 3)
        self.key = "slots" if slots else "img"
        self.x = (randn(r, *shape) if slots
                  else r.uniform(-1, 1, shape).astype(np.float32))

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {self.key: self.x[i], "data_idx": i}


def _fit(params, train_set, val_set, ckp):
    torch.manual_seed(0)
    method = build_method(
        model=build_model(params, device="cpu"),
        datamodule=BaseDataModule(params, train_set, val_set), params=params,
        ckp_path=str(ckp))
    before = {k: v.clone() for k, v in method.model.state_dict().items()}
    method.fit(san_check_val_step=1)
    with open(os.path.join(ckp, "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    return method, before, [r for r in log if r["phase"] == "train"]


def _moved(before, after, prefix):
    return max(float((after[k] - before[k]).abs().max())
               for k in before
               if k.startswith(prefix) and before[k].is_floating_point())


def test_steve_method_grafts_a_port_dvae_and_keeps_it_frozen(tmp_path):
    """A dVAE trained by ``dVAEMethod`` (its checkpoint holds the dVAE at its
    root) grafted into STEVE: ``fit`` leaves it bit-equal, and the token
    decoder, a param group of its own at ``dec_lr``, trains."""
    dparams = BaseParams(model="dVAE", vocab_size=16, resolution=RES, lr=1e-3,
                         tau_decay_pct=0.5, **TINY_TRAIN)
    dmethod, _, dlog = _fit(dparams, _Clips(8, 1), _Clips(4, 1, seed=1),
                            tmp_path / "dvae")
    assert type(dmethod) is dVAEMethod
    assert [r["tau"] for r in dlog] == pytest.approx(
        [dVAEMethod.train_loss_kwargs(dmethod, s)["tau"] for s in range(2)])
    assert dlog[0]["tau"] == 1.0 and dlog[1]["tau"] < 1.0
    dvae_ckp = latest_checkpoint(str(tmp_path / "dvae"))
    dvae_sd = load_checkpoint(dvae_ckp)["state_dict"]
    assert not any(k.startswith("dvae.") for k in dvae_sd)

    cfg = steve_cfg(RES)
    sparams = BaseParams(
        model="STEVE", input_frames=2, lr=1e-4, dec_lr=3e-4, clip_grad=0.05,
        **{k: v for k, v in cfg.items() if k not in ("clip_len", "dvae_dict")},
        dvae_dict=dict(TINY_DVAE, dvae_ckp_path=dvae_ckp), **TINY_TRAIN)
    method, before, log = _fit(sparams, _Clips(8, 2), _Clips(4, 2, seed=1),
                               tmp_path / "steve")
    assert type(method) is STEVEMethod
    groups = method.optimizer.optimizer.param_groups
    dec = dict(method.model.trans_decoder.named_parameters())
    assert len(groups) == 2 and len(groups[1]["params"]) == len(dec)
    assert all(np.isfinite(r["token_recon_loss"]) for r in log) and len(log) == 2
    after = method.model.state_dict()
    for k, v in dvae_sd.items():
        assert torch.equal(after["dvae." + k], v), k
    assert _moved(before, after, "trans_decoder.") > 1e-6
    assert _moved(before, after, "slot_attention.") > 1e-6

    sparams.dvae_dict["dvae_ckp_path"] = ""
    with pytest.raises(ValueError, match="dvae_ckp_path"):
        _fit(sparams, _Clips(4, 2), _Clips(4, 2, seed=1), tmp_path / "none")


def test_steve_slotformer_method_grafts_steve_and_keeps_it_frozen(tmp_path):
    """``decoder`` <- the STEVE checkpoint's ``trans_decoder``, ``dvae`` <-
    its ``dvae``, both bit-frozen by ``fit``; the rollouter trains."""
    torch.manual_seed(1)
    steve_sd = {k: v + 0.01 * torch.randn_like(v) if v.is_floating_point() else v
                for k, v in STEVE(**steve_cfg(RES)).state_dict().items()}
    steve_ckp = str(tmp_path / "steve" / "model_5.pth")
    save_checkpoint(steve_ckp, steve_sd)
    cfg = sf_cfg(RES)
    params = BaseParams(
        model="STEVESlotFormer", input_frames=2, n_sample_frames=5, lr=1e-3,
        **{k: v for k, v in cfg.items() if k not in ("clip_len", "dec_dict")},
        dec_dict=dict(cfg["dec_dict"], dec_ckp_path=steve_ckp), **TINY_TRAIN)
    method, before, log = _fit(params, _Clips(8, 5, slots=True),
                               _Clips(4, 5, seed=1, slots=True), tmp_path / "sf")
    assert type(method) is STEVESlotFormerMethod
    assert all(np.isfinite(r["slot_recon_loss"]) for r in log) and len(log) == 2
    after = method.model.state_dict()
    for k, v in after.items():
        if k.startswith("decoder."):
            assert torch.equal(v, steve_sd["trans_" + k]), k
        elif k.startswith("dvae."):
            assert torch.equal(v, steve_sd[k]), k
    assert _moved(before, after, "rollouter.") > 1e-6


def test_build_method_lists_what_is_ported():
    # every model of the JAX package has its method now: a name of none
    with pytest.raises(NotImplementedError, match="'STEVESlotFormer'"):
        build_method(params=BaseParams(model="NoSuchModel"))


# ---------------------------------------------------------------- CLI

TRAIN_CFG = """
    max_epochs = 1
    eval_interval = 1
    print_iter = 1
    optimizer = 'Adam'
    lr = 1e-3
    warmup_steps_pct = 0.1
    n_samples = 1
"""


def _log(ckp):
    with open(os.path.join(ckp, "log.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["phase"] == "train"]


def test_cli_trains_the_physion_pipeline(tree):
    """``cli.train --device cpu`` for the dVAE, then STEVE on its tokens with
    it grafted, then STEVESlotFormer on STEVE's slots with STEVE's token
    decoder and dVAE grafted: finite losses, tau falling, frozen subtrees
    bit-equal to their sources, the sample videos and a checkpoint a run."""
    dvae_cfg = _write_cfg("dvae_tiny_params.py", DVAE_CFG + TRAIN_CFG, False)
    train_cli.main(["--params", dvae_cfg, "--ckp_path", "ckpts/dvae_tiny_params",
                    "--device", "cpu"])
    dlog = _log("ckpts/dvae_tiny_params")
    assert len(dlog) == 8 and dlog[0]["tau"] == 1.0 > dlog[-1]["tau"]
    assert os.path.isfile("ckpts/dvae_tiny_params/vis/recon_8.mp4")
    dvae_ckp = latest_checkpoint("ckpts/dvae_tiny_params")
    tokenize_images.main(["--params", dvae_cfg, "--weight", dvae_ckp,
                          "--device", "cpu"])

    dvae_dict = ("    dvae_dict = dict(down_factor=4, vocab_size=16, "
                 f"dvae_ckp_path={dvae_ckp!r})\n")
    steve_cfg_path = _write_cfg(
        "steve_tiny_params.py", STEVE_CFG + TRAIN_CFG + dvae_dict
        + "    dec_lr = 3e-4\n    clip_grad = 0.05\n", False)
    # the loader reads the tokens just written: TrainNpys-dvae_tiny_params
    assert build_dataset(load_params(steve_cfg_path))[0][0]["token_id"].shape == (2, 16)
    train_cli.main(["--params", steve_cfg_path, "--ckp_path",
                    "ckpts/steve_tiny_params", "--device", "cpu"])
    slog = _log("ckpts/steve_tiny_params")
    assert len(slog) == 7 and all(np.isfinite(r["token_recon_loss"]) for r in slog)
    assert os.path.isfile("ckpts/steve_tiny_params/vis/decomp_7.mp4")
    steve_ckp = latest_checkpoint("ckpts/steve_tiny_params")
    steve_sd = load_checkpoint(steve_ckp)["state_dict"]
    for k, v in load_checkpoint(dvae_ckp)["state_dict"].items():
        assert torch.equal(steve_sd["dvae." + k], v), k
    extract_slots.main(["--params", steve_cfg_path, "--weight", steve_ckp,
                        "--subset", "training", "--save_path",
                        "data/Physion/training_slots.pkl", "--batch_size", "2",
                        "--device", "cpu"])

    sf_cfg_path = _write_cfg(
        "sf_tiny_params.py",
        SF_CFG.format(slots_root="data/Physion/training_slots.pkl") + TRAIN_CFG
        + f"    dec_dict = dict(dec_num_layers=1, dec_num_heads=2, "
        f"dec_d_model=16, dec_ckp_path={steve_ckp!r})\n", False)
    train_cli.main(["--params", sf_cfg_path, "--ckp_path", "ckpts/sf_tiny_params",
                    "--device", "cpu"])
    flog = _log("ckpts/sf_tiny_params")
    assert len(flog) == 3 and all(np.isfinite(r["slot_recon_loss"]) for r in flog)
    assert os.path.isfile("ckpts/sf_tiny_params/vis/rollout_3.mp4")
    sf_sd = load_checkpoint(latest_checkpoint("ckpts/sf_tiny_params"))["state_dict"]
    for k, v in sf_sd.items():
        if k.startswith("decoder."):
            assert torch.equal(v, steve_sd["trans_" + k]), k
        elif k.startswith("dvae."):
            assert torch.equal(v, steve_sd[k]), k
