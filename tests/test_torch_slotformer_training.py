"""Port vs JAX: SlotFormer training.

The losses (``calc_train_loss``, the four image-loss branches of
``train_loss``, ``eval_loss``), the frozen-decoder loss ``Function`` (value
and every gradient against ``jax.grad`` and against torch autograd of the
plain decode), ``graft``, ``SlotFormerMethod`` (ramp, grafting, frozen
decoder) and the reference's 12-step trajectory ``sftraj_golden.npz``.

Inputs and weights are the same numpy arrays on both sides; every model runs
dropout-free (``dropout=0.0`` in ``rollout_dict``). Tolerances: losses 1e-5
relative (float32 on both sides, summed in different orders); gradients 1e-5
of each gradient's largest entry for the loss ``Function`` (one decoder pass)
and 1e-4 through the rollouter (4 autoregressive transformer steps before
it); the bfloat16 branch against the port's own float32 value at rtol 3e-2
(image loss) and 2e-5 (slot loss), tests/test_models.py:495-530's, since the
CPU's bfloat16 sums differ from XLA's; the golden trajectory at rtol 5e-3,
atol 1e-5 (tests/test_sftraj_parity.py's).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotformer_tpu.methods import SlotFormerMethod as JaxSlotFormerMethod
from slotformer_tpu.models.slotformer import SlotFormer as JaxSlotFormer
from slotformer_tpu.models.slotformer import _pick_chunks as jax_pick_chunks
from slotformer_tpu.ops.frozen_decoder_loss import (
    frozen_decoder_recon_loss as jax_frozen_loss,
)
from slotformer_tpu_torch.methods import SlotFormerMethod, build_method
from slotformer_tpu_torch.models import build_model
from slotformer_tpu_torch.models.slotformer import SlotFormer, _pick_chunks
from slotformer_tpu_torch.ops import frozen_decoder_recon_loss
from slotformer_tpu_torch.runtime import (
    BaseDataModule,
    BaseParams,
    graft,
    load_checkpoint,
    save_checkpoint,
)
from slotformer_tpu_torch.runtime.weights import from_jax_params
from torch_port_helpers import (
    GOLDEN,
    close,
    jax_init,
    randn,
    rng,
    sf_batch,
    sf_cfg,
    state_dict,
    t,
    tensors,
)

LOSS_RTOL = 1e-5
BRANCHES = {
    "plain": dict(dec_chunk_frames=0),
    "chunked": dict(dec_chunk_frames=4),  # 8 frames -> 2 chunks
    "custom": dict(dec_custom_bwd=True, dec_chunk_frames=0),
    "custom_chunked": dict(dec_custom_bwd=True, dec_chunk_frames=4),
}


def _pair(seed=0, **loss_dict):
    """(jax model, its random params, the port with the same weights)."""
    cfg = sf_cfg(**loss_dict)
    jmod = JaxSlotFormer(**cfg)
    params = jax_init(jmod, {"slots": np.zeros((1, 7, 4, 16), np.float32)},
                      seed=seed)
    port = SlotFormer(**cfg).train()
    port.load_state_dict(from_jax_params(params, "SlotFormer",
                                         types.SimpleNamespace(**cfg)))
    return jmod, params, port, cfg


def _jax_losses_and_grads(jmod, params, batch, factor=1.0):
    def total(p):
        ld = jmod.apply({"params": p}, batch, factor, method="train_loss",
                        rngs={"dropout": jax.random.PRNGKey(0)})
        return ld["slot_recon_loss"] + ld["img_recon_loss"], ld

    (_, ld), grads = jax.jit(jax.value_and_grad(total, has_aux=True))(params)
    return ld, grads


def _port_losses_and_grads(port, batch, factor=1.0):
    port.zero_grad(set_to_none=True)
    ld = port.train_loss(tensors(batch), loss_decay_factor=factor)
    (ld["slot_recon_loss"] + ld["img_recon_loss"]).backward()
    return ld, {n: p.grad for n, p in port.named_parameters()}


def _close_grads(got: dict, want: dict, rel: float, prefix="rollouter."):
    names = [n for n in got if n.startswith(prefix) and got[n] is not None]
    assert names
    for n in names:
        scale = float(want[n].abs().max())
        close(got[n], want[n].numpy(), rtol=0, atol=rel * scale + 1e-12)


@pytest.mark.parametrize("factor", [1.0, 0.3])
@pytest.mark.parametrize("vid_len", [False, True])
def test_calc_train_loss_matches_jax(vid_len, factor):
    jmod, params, port, _ = _pair(seed=1, dec_chunk_frames=0)
    batch = sf_batch(2, vid_len)
    out = jmod.apply({"params": params}, batch)
    want = jmod.apply({"params": params}, batch, out, factor,
                      method="calc_train_loss")
    want_eval = jmod.apply({"params": params}, batch, method="eval_loss")
    with torch.no_grad():
        tb = tensors(batch)
        got = port.calc_train_loss(tb, port(tb), loss_decay_factor=factor)
        got_eval = port.eval().eval_loss(tb)
    assert sorted(got) == sorted(want) == ["img_recon_loss", "slot_recon_loss"]
    assert sorted(got_eval) == sorted(want_eval) and len(got_eval) == 6
    for k in want:
        close(got[k], want[k], rtol=LOSS_RTOL, atol=0)
    for k in want_eval:
        close(got_eval[k], want_eval[k], rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("vid_len", [False, True])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_train_loss_branch_matches_jax(branch, vid_len):
    """Each branch's losses against the same branch in JAX, and its
    rollouter gradients against JAX's (which flow through the frozen
    decoder); the decoder gets no gradient outside the plain branch."""
    jmod, params, port, cfg = _pair(seed=2, **BRANCHES[branch])
    batch = sf_batch(3, vid_len)
    want, jgrads = _jax_losses_and_grads(jmod, params, batch, factor=0.5)
    got, grads = _port_losses_and_grads(port, batch, factor=0.5)
    for k in want:
        close(got[k], want[k], rtol=LOSS_RTOL, atol=0)
    want_grads = from_jax_params(jax.tree.map(np.asarray, jgrads), "SlotFormer",
                                 types.SimpleNamespace(**cfg))
    _close_grads(grads, want_grads, rel=1e-4)
    if branch != "plain":
        assert all(g is None for n, g in grads.items() if n.startswith("decoder"))


@pytest.mark.parametrize("vid_len", [False, True])
def test_branches_agree_with_plain(vid_len):
    """Chunked = unchunked, custom = plain: values and rollouter gradients
    within the port."""
    batch = sf_batch(4, vid_len)
    ref = None
    for branch in ("plain", "chunked", "custom", "custom_chunked"):
        _, _, port, _ = _pair(seed=3, **BRANCHES[branch])
        ld, grads = _port_losses_and_grads(port, batch)
        if ref is None:
            ref = (ld, grads)
            continue
        for k in ref[0]:
            # the eps of the vid_len denominator sits elsewhere in the
            # custom branch (tests/test_models.py:301)
            close(ld[k], ref[0][k].detach().numpy(), rtol=2e-5, atol=0)
        _close_grads(grads, {n: g for n, g in ref[1].items() if g is not None},
                     rel=1e-4)


@pytest.mark.parametrize("vid_len", [False, True])
def test_bf16_branch_matches_f32(vid_len):
    _, _, base, _ = _pair(seed=4, dec_chunk_frames=0)
    _, _, bf16, _ = _pair(seed=4, dec_chunk_frames=0, dec_recon_bf16=True)
    batch = sf_batch(5, vid_len)
    want, _ = _port_losses_and_grads(base, batch)
    got, grads = _port_losses_and_grads(bf16, batch)
    assert got["img_recon_loss"].dtype == torch.float32
    close(got["img_recon_loss"], want["img_recon_loss"].detach().numpy(),
          rtol=3e-2, atol=0)
    close(got["slot_recon_loss"], want["slot_recon_loss"].detach().numpy(),
          rtol=2e-5, atol=0)
    gnorm = sum(float(g.square().sum()) for n, g in grads.items()
                if n.startswith("rollouter.") and g is not None)
    assert np.isfinite(gnorm) and gnorm > 0
    # the weights are detached before the cast: no gradient for the decoder
    assert all(g is None for n, g in grads.items() if n.startswith("decoder"))


def test_branch_precedence_and_refusals():
    """custom > bf16 > chunked, as in JAX; a decoder norm is refused."""
    _, _, port, _ = _pair(seed=5, dec_custom_bwd=True, dec_recon_bf16=True,
                          dec_chunk_frames=4)
    calls = []
    port._custom_bwd_img_recon_loss = lambda b, s: calls.append("custom") or s.sum()
    port._bf16_img_recon_loss = lambda b, s: calls.append("bf16") or s.sum()
    port._chunked_img_recon_loss = lambda b, s, nc: calls.append("chunked") or s.sum()
    batch = tensors(sf_batch(6))
    port.train_loss(batch)
    port.dec_custom_bwd = False
    port.train_loss(batch)
    port.dec_recon_bf16 = False
    port.train_loss(batch)
    assert calls == ["custom", "bf16", "chunked"]
    cfg = sf_cfg(dec_custom_bwd=True)
    cfg["dec_dict"]["dec_norm"] = "bn"
    with pytest.raises((ValueError, NotImplementedError)):
        SlotFormer(**cfg)
    assert SlotFormer(**sf_cfg()).dec_chunk_frames == 160  # the JAX default


@pytest.mark.parametrize("n,m", [(8, 2), (8, 3), (1280, 160), (640, 160),
                                 (7, 4), (12, 0), (5, 8)])
def test_pick_chunks_matches_jax(n, m):
    assert _pick_chunks(n, m) == jax_pick_chunks(n, m)


# ------------------------------------------------------ the loss Function

def _op_inputs(use_vid_len, seed=7):
    F_, S, D, H, W = 6, 4, 16, 16, 16
    r = rng(seed)
    slots, gt = randn(r, F_, S, D), randn(r, F_, H, W, 3)
    if use_vid_len:
        w = np.array([1, 1, 0, 1, 1, 0], np.float32)
        denom = np.float32(w.sum() * H * W * 3 + 1e-6)
    else:
        w = np.array([1.0, 0.5, 2.0, 1.0, 0.25, 1.5], np.float32)
        denom = np.float32(1234.5)
    return slots, gt, w, denom


@pytest.mark.parametrize("use_vid_len,chunk", [(False, 0), (True, 0),
                                               (False, 3), (True, 3)])
def test_frozen_decoder_loss_matches_jax_and_autograd(use_vid_len, chunk):
    """Value and d slots, d gt, d w, d denom of the ``Function`` against
    ``jax.grad`` of JAX's custom-VJP op and against torch autograd of the
    plain decode; with ``chunk``, as the sum of per-chunk calls under one
    global denom (how the chunked custom branch composes it)."""
    jmod, params, port, cfg = _pair(seed=6)
    dec = port.spatial_decoder
    slots, gt, w, denom = _op_inputs(use_vid_len)
    S = 4
    jcfg = ((16, 8, 8), (4, 4), (16, 16), 3)
    n_chunks = 1 if not chunk else len(slots) // chunk
    parts = lambda a: np.split(a, n_chunks)  # noqa: E731

    def jax_total(s, g, ww, d):
        return sum(jax_frozen_loss(params["decoder"], sc, gc, wc, d, jcfg, S)
                   for sc, gc, wc in zip(parts(s), parts(g), parts(ww)))

    want, want_g = jax.value_and_grad(jax_total, argnums=(0, 1, 2, 3))(
        jnp.asarray(slots), jnp.asarray(gt), jnp.asarray(w), jnp.asarray(denom))

    def leaves():
        return [t(a).requires_grad_(True) for a in (slots, gt, w, denom)]

    def custom(s, g, ww, d):
        return sum(frozen_decoder_recon_loss(dec, sc, gc, wc, d, S)
                   for sc, gc, wc in zip(s.chunk(n_chunks), g.chunk(n_chunks),
                                         ww.chunk(n_chunks)))

    def plain(s, g, ww, d):
        recon = dec(s)[0]
        return (((recon - g) ** 2).sum(dim=(1, 2, 3)) * ww).sum() / d

    xs = leaves()
    got = custom(*xs)
    got_g = torch.autograd.grad(got, xs)
    ys = leaves()
    ref = plain(*ys)
    ref_g = torch.autograd.grad(ref, ys)
    close(got, want, rtol=LOSS_RTOL, atol=0)
    close(got, ref.detach().numpy(), rtol=LOSS_RTOL, atol=0)
    for name, a, b, c in zip(("slots", "gt", "w", "denom"), got_g, want_g, ref_g):
        assert a.shape == c.shape and a.dtype == c.dtype, name
        for other in (np.asarray(b), c.numpy()):
            scale = float(np.abs(other).max())
            assert scale > 0, name
            close(a, other, rtol=0, atol=1e-5 * scale)
    assert all(p.grad is None for p in dec.parameters())


def test_frozen_decoder_loss_saves_masks_not_activations():
    """What the ``Function`` keeps for its backward: one bool mask per deconv
    layer, and no float tensor as large as a deconv layer's activation."""
    _, _, port, _ = _pair(seed=8)
    slots, gt, w, denom = (t(a) for a in _op_inputs(False))
    loss = frozen_decoder_recon_loss(port.spatial_decoder,
                                     slots.requires_grad_(True), gt, w, denom, 4)
    saved = loss.grad_fn.saved_tensors
    FS = slots.shape[0] * slots.shape[1]
    act_sizes = {FS * 8 * 8 * 8, FS * 8 * 16 * 16}  # the two deconv outputs
    bools = [s for s in saved if s.dtype == torch.bool]
    floats = [s for s in saved if s.is_floating_point()]
    assert sorted(b.numel() for b in bools) == sorted(act_sizes)
    # the head's masks and rgb, the residual, the per-frame SSE, w, denom
    assert max(f.numel() for f in floats) <= FS * 3 * 16 * 16
    assert not any(f.numel() in act_sizes for f in floats)
    assert all(f.dtype == torch.float32 for f in floats)


def test_frozen_decoder_loss_under_bf16_autocast():
    """The decode in bfloat16 (autocast), the loss side in float32; the
    gradients come back in the inputs' dtypes."""
    _, _, port, _ = _pair(seed=9)
    dec = port.spatial_decoder
    slots, gt, w, denom = (t(a) for a in _op_inputs(False))
    slots.requires_grad_(True)
    want = frozen_decoder_recon_loss(dec, slots, gt, w, denom, 4)
    (want_g,) = torch.autograd.grad(want, slots)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = frozen_decoder_recon_loss(dec, slots, gt, w, denom, 4)
        # autograd of the same bfloat16 decode
        ref = (((dec(slots)[0].float() - gt) ** 2).sum(dim=(1, 2, 3)) * w
               ).sum() / denom
    (ref_g,) = torch.autograd.grad(ref, slots)
    saved = got.grad_fn.saved_tensors
    assert sum(s.dtype == torch.bool for s in saved) == 2
    assert any(s.dtype == torch.bfloat16 for s in saved)  # the head's outputs
    (got_g,) = torch.autograd.grad(got, slots)
    assert got.dtype == torch.float32 and got_g.dtype == torch.float32
    # bfloat16 keeps 8 bits: the gradient is within a tenth of its largest
    # entry of the float32 one, and within 2% of autograd's bfloat16 one
    scale = float(want_g.abs().max())
    close(got, want.detach().numpy(), rtol=0.05, atol=0)
    close(got_g, want_g.numpy(), rtol=0, atol=0.1 * scale)
    close(got_g, ref_g.numpy(), rtol=0, atol=0.02 * scale)


# ------------------------------------------------------------------ graft

def _savi_like_sd(port, seed=0):
    """A state_dict with a decoder of ``port``'s shapes and other keys."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in
          port.state_dict().items() if k.startswith("decoder")}
    sd["encoder.0.0.weight"] = torch.zeros(3)
    return sd


@pytest.mark.parametrize("wrapped", [True, False])
def test_graft_takes_both_decoder_prefixes(wrapped, tmp_path):
    """From a checkpoint of the port (``{'state_dict': ...}``) and from a
    bare reference state_dict alike; nothing else moves."""
    _, _, port, _ = _pair(seed=10)
    src = _savi_like_sd(port)
    path = str(tmp_path / "savi.pth")
    if wrapped:
        save_checkpoint(path, src, it=3)
    else:
        torch.save(src, path)
    dst = port.state_dict()
    out = graft(dst, load_checkpoint(path), ("decoder", "decoder_pos_embedding"))
    assert sorted(out) == sorted(dst)
    for k, v in out.items():
        assert torch.equal(v, src[k] if k.startswith("decoder") else dst[k]), k
    assert sum(k.startswith("decoder_pos_embedding.") for k in out) == 3


def test_graft_raises_on_missing_key_and_shape():
    _, _, port, _ = _pair(seed=11)
    dst, src = port.state_dict(), _savi_like_sd(port)
    lacking = {k: v for k, v in src.items() if k != "decoder.1.0.bias"}
    with pytest.raises(KeyError, match="decoder.1.0.bias"):
        graft(dst, lacking, ("decoder",))
    with pytest.raises(KeyError):
        graft(dst, src, ("no_such_prefix",))
    bad = dict(src, **{"decoder.0.0.weight": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        graft(dst, bad, ("decoder",))
    extra = dict(src, **{"decoder.9.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="lacks"):
        graft(dst, extra, ("decoder",))
    graft(dst, extra, ("decoder",), strict=False)
    # a map renames: the target's decoder from another name in the source
    renamed = {k.replace("decoder.", "dec."): v for k, v in src.items()}
    out = graft(dst, renamed, {"decoder": "dec"})
    assert torch.equal(out["decoder.0.0.weight"], src["decoder.0.0.weight"])


# ---------------------------------------------------------- SlotFormerMethod

class _Slots:
    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return len(self.batch["slots"])

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.batch.items()}


def _sf_params(**over):
    cfg = sf_cfg()
    return BaseParams(**{**dict(
        model="SlotFormer", max_epochs=16, optimizer="Adam", lr=3e-4,
        warmup_steps_pct=0.0, train_batch_size=2, val_batch_size=2,
        num_workers=0, print_iter=1, input_frames=3, n_sample_frames=7,
        use_loss_decay=True, loss_decay_pct=0.5, slot_recon_loss_w=1.0,
        img_recon_loss_w=1.0, **cfg), **over})


def test_method_ramp_matches_jax_and_starts_at_step_zero(tmp_path):
    """The factor of step i is min(0.01 + i / decay_steps * 0.99, 1) with i
    from 0: the first step trains at 0.01. Against the JAX method's own
    function, and in the trainer's log."""
    params = _sf_params(max_epochs=8)
    batch = sf_batch(12)
    torch.manual_seed(0)
    method = build_method(model=build_model(params, device="cpu"),
                          datamodule=BaseDataModule(params, _Slots(batch), None),
                          params=params, ckp_path=str(tmp_path / "ckp"))
    assert isinstance(method, SlotFormerMethod) and method.total_steps == 8
    fake = types.SimpleNamespace(params=params, total_steps=8)
    for i in range(10):
        want = JaxSlotFormerMethod.train_loss_kwargs(fake, i)
        got = method.train_loss_kwargs(i)
        assert sorted(got) == sorted(want) == ["loss_decay_factor"]
        assert got["loss_decay_factor"] == pytest.approx(
            float(want["loss_decay_factor"]), rel=1e-6)
    assert method.train_loss_kwargs(0) == {"loss_decay_factor": 0.01}
    off = build_method(model=method.model, datamodule=method.datamodule,
                       params=_sf_params(use_loss_decay=False), ckp_path="")
    assert off.train_loss_kwargs(3) == {}
    assert build_method(model=method.model, datamodule=method.datamodule,
                        params=_sf_params(loss_decay_pct=0.0),
                        ckp_path="").train_loss_kwargs(3) == {}
    log = []
    method._log = log.append
    method.fit(san_check_val_step=0)
    factors = [r["loss_decay_factor"] for r in log if r["phase"] == "train"]
    np.testing.assert_allclose(
        factors, [min(0.01 + i / 4 * 0.99, 1.0) for i in range(8)], rtol=1e-6)


def test_method_grafts_decoder_and_keeps_it_frozen(tmp_path):
    """``setup_state`` grafts ``dec_ckp_path``'s decoder; ``fit`` trains the
    rollouter and leaves every decoder tensor bit-equal."""
    params = _sf_params(max_epochs=3)
    torch.manual_seed(1)
    model = build_model(params, device="cpu")
    src = _savi_like_sd(model, seed=5)
    ckp = str(tmp_path / "savi.pth")
    save_checkpoint(ckp, src)
    params.dec_dict["dec_ckp_path"] = ckp
    before = {k: v.clone() for k, v in model.state_dict().items()}
    method = build_method(model=model,
                          datamodule=BaseDataModule(params, _Slots(sf_batch(13)), None),
                          params=params, ckp_path=str(tmp_path / "ckp"))
    method.fit(san_check_val_step=0)
    after = model.state_dict()
    moved = 0.0
    for k, v in after.items():
        if k.startswith("decoder"):
            assert torch.equal(v, src[k]), k
        elif v.is_floating_point() and "pe" not in k:
            moved = max(moved, float((v - before[k]).abs().max()))
    assert moved > 1e-5 and method.it == 3
    assert not any(p.requires_grad for n, p in model.named_parameters()
                   if n.startswith("decoder"))


def test_sftraj_golden_trajectory():
    """12 Adam(3e-4) steps of the reference's SlotFormer recipe from the
    golden ``sd/``: both loss trajectories, with the factor of every step
    taken from ``SlotFormerMethod.train_loss_kwargs`` (ramp over 8 steps,
    then clamped at 1), ``vid_len`` masking, and the decoder bit-frozen
    while the gradient flows through it."""
    gold = np.load(os.path.join(GOLDEN, "sftraj_golden.npz"))
    sd = {k[3:]: gold[k] for k in gold.files if k.startswith("sd/")}
    params = BaseParams(
        model="SlotFormer", max_epochs=16, optimizer="Adam", lr=3e-4,
        train_batch_size=2, num_workers=0, input_frames=4, n_sample_frames=10,
        use_loss_decay=True, loss_decay_pct=0.5, resolution=(16, 16),
        slot_dict=dict(num_slots=5, slot_size=16),
        rollout_dict=dict(num_slots=5, slot_size=16, history_len=4, t_pe="sin",
                          slots_pe="", d_model=16, num_layers=2, num_heads=2,
                          ffn_dim=32, norm_first=True, dropout=0.0),
        dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4), dec_ks=3,
                      dec_norm="", dec_ckp_path=""),
        loss_dict=dict(rollout_len=6, use_img_recon_loss=True))
    batch = {"slots": np.asarray(gold["in/slots"]),
             # the reference's video is NCHW; the port's NHWC
             "img": np.transpose(np.asarray(gold["in/img"]), (0, 1, 3, 4, 2)),
             "vid_len": np.asarray(gold["in/vid_len"], np.int64)}
    model = build_model(params, device="cpu")
    model.load_state_dict(state_dict(sd))
    # 16 total steps x loss_decay_pct 0.5 = the golden's 8 decay steps
    method = build_method(model=model,
                          datamodule=BaseDataModule(params, _Slots(batch), None),
                          params=params, ckp_path="")
    assert method.total_steps == 16
    trainable = [p for p in model.parameters() if p.requires_grad]
    assert not any(p.requires_grad for n, p in model.named_parameters()
                   if n.startswith("decoder"))
    opt = torch.optim.Adam(trainable, lr=3e-4)
    tb = tensors(batch)
    model.train()
    slot_losses, img_losses = [], []
    for i in range(12):
        ld = model.train_loss(tb, **method.train_loss_kwargs(i))
        opt.zero_grad()
        (ld["slot_recon_loss"] + ld["img_recon_loss"]).backward()
        opt.step()
        slot_losses.append(float(ld["slot_recon_loss"]))
        img_losses.append(float(ld["img_recon_loss"]))
    np.testing.assert_allclose(slot_losses, gold["out/slot_losses"],
                               rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(img_losses, gold["out/img_losses"],
                               rtol=5e-3, atol=1e-5)
    for k, v in model.state_dict().items():
        if k.startswith("decoder"):
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
        elif k.endswith("in_proj.weight"):
            assert not np.array_equal(v.numpy(), sd[k])
